// Host library of the port's AP metering (C++, no CUDA).
//
// Counterpart of the AP functions of native/coda_native.cpp, copied:
//   * clip_area_eval_cpu: the eval path's Sutherland-Hodgman intersection
//     area of two quads (inside := cross > 1e-12, collinear points kept);
//   * box3d_iou_eval_cpu: the rotated 3D IoU of one box against many, as
//     utils/eval_det.py :: box3d_iou computes it;
//   * nms_3d_samecls_cpu: greedy same-class 3D NMS, as utils/nms.py ::
//     nms_3d_faster_samecls.
// It runs on the host beside the card; it is not a port of a TPU kernel.
// coda_neurips2023_tpu_torch/native.py builds it with g++ at first use into
// build/torch_kernels/ and binds it with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Eval-path variant (box_util.py:36-107): inside := cross > 1e-12, plus the
// keep-collinear branch so identical boxes give full overlap; used by the
// VOC AP IoU (eval_det.py get_iou_obb).
double clip_area_eval_cpu(const float* subject, const float* clip) {
  double out[24][2], in[24][2];
  int n_out = 4;
  // eval path iterates rects in given order; caller passes the CCW [3,2,1,0]
  for (int i = 0; i < 4; ++i) { out[i][0] = subject[i * 2]; out[i][1] = subject[i * 2 + 1]; }
  double cp1[2] = {clip[3 * 2], clip[3 * 2 + 1]};
  const double TOL = 1e-12;
  for (int c = 0; c < 4; ++c) {
    double cp2[2] = {clip[c * 2], clip[c * 2 + 1]};
    int n_in = n_out;
    std::memcpy(in, out, sizeof(double) * 2 * n_in);
    n_out = 0;
    if (n_in == 0) return 0.0;
    double s[2] = {in[n_in - 1][0], in[n_in - 1][1]};
    for (int i = 0; i < n_in && n_out < 23; ++i) {
      double e[2] = {in[i][0], in[i][1]};
      const double ce = (cp2[0] - cp1[0]) * (e[1] - cp1[1]) - (cp2[1] - cp1[1]) * (e[0] - cp1[0]);
      const double cs = (cp2[0] - cp1[0]) * (s[1] - cp1[1]) - (cp2[1] - cp1[1]) * (s[0] - cp1[0]);
      const bool ie = ce > TOL, is = cs > TOL;
      if (ie != is) {
        const double dc0 = cp1[0] - cp2[0], dc1 = cp1[1] - cp2[1];
        const double dp0 = s[0] - e[0], dp1 = s[1] - e[1];
        const double n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0];
        const double n2 = s[0] * e[1] - s[1] * e[0];
        const double den = dc0 * dp1 - dc1 * dp0;
        if (den != 0.0) {
          const double n3 = 1.0 / den;
          out[n_out][0] = (n1 * dp0 - n2 * dc0) * n3;
          out[n_out][1] = (n1 * dp1 - n2 * dc1) * n3;
        } else {
          out[n_out][0] = e[0]; out[n_out][1] = e[1];
        }
        ++n_out;
      }
      if (ie) { out[n_out][0] = e[0]; out[n_out][1] = e[1]; ++n_out; }
      else if (!is && std::fabs(cs) <= TOL && std::fabs(ce) <= TOL) {
        out[n_out][0] = e[0]; out[n_out][1] = e[1]; ++n_out;  // keep collinear
      }
      s[0] = e[0]; s[1] = e[1];
    }
    cp1[0] = cp2[0]; cp1[1] = cp2[1];
    if (n_out == 0) return 0.0;
  }
  if (n_out < 3) return 0.0;
  double acc = 0.0;
  for (int i = 0; i < n_out; ++i) {
    const int p = (i + n_out - 1) % n_out;
    acc += out[i][0] * out[p][1] - out[i][1] * out[p][0];
  }
  return 0.5 * std::fabs(acc);
}

// eval-path rotated 3D IoU of one box vs many (corners (8,3) camera frame)
void box3d_iou_eval_cpu(const float* bb, const float* gts, int m, double* out_iou) {
  float rect1[8];
  for (int i = 0; i < 4; ++i) {
    rect1[i * 2] = bb[(3 - i) * 3 + 0];
    rect1[i * 2 + 1] = bb[(3 - i) * 3 + 2];
  }
  auto vol = [](const float* c) {
    auto d = [&](int a, int b) {
      double dx = c[a * 3] - c[b * 3], dy = c[a * 3 + 1] - c[b * 3 + 1],
             dz = c[a * 3 + 2] - c[b * 3 + 2];
      return std::sqrt(dx * dx + dy * dy + dz * dz);
    };
    return d(0, 1) * d(1, 2) * d(0, 4);
  };
  const double vol1 = vol(bb);
  for (int j = 0; j < m; ++j) {
    const float* gt = gts + (size_t)j * 24;
    float rect2[8];
    for (int i = 0; i < 4; ++i) {
      rect2[i * 2] = gt[(3 - i) * 3 + 0];
      rect2[i * 2 + 1] = gt[(3 - i) * 3 + 2];
    }
    const double inter_area = clip_area_eval_cpu(rect1, rect2);
    const double ymax = std::min(bb[0 * 3 + 1], gt[0 * 3 + 1]);
    const double ymin = std::max(bb[4 * 3 + 1], gt[4 * 3 + 1]);
    const double inter_vol = inter_area * std::max(0.0, ymax - ymin);
    const double vol2 = vol(gt);
    out_iou[j] = inter_vol / std::max(vol1 + vol2 - inter_vol, 1e-12);
  }
}

// ------------------------------------------------- 3D same-class NMS
// boxes: (k, 8) [x1,y1,z1,x2,y2,z2,score,cls]; out keep flags (k,) int32;
// returns number kept.  Greedy by ascending argsort, pop max (nms.py:120-162).
int nms_3d_samecls_cpu(const float* boxes, int k, float thresh, int old_type,
                       int32_t* keep) {
  std::vector<int> order(k);
  std::vector<float> area(k);
  for (int i = 0; i < k; ++i) {
    order[i] = i;
    area[i] = (boxes[i * 8 + 3] - boxes[i * 8 + 0]) *
              (boxes[i * 8 + 4] - boxes[i * 8 + 1]) *
              (boxes[i * 8 + 5] - boxes[i * 8 + 2]);
  }
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return boxes[a * 8 + 6] < boxes[b * 8 + 6];
  });
  std::memset(keep, 0, sizeof(int32_t) * k);
  int n_keep = 0;
  std::vector<int> I(order);
  while (!I.empty()) {
    const int i = I.back();
    I.pop_back();
    keep[i] = 1;
    ++n_keep;
    std::vector<int> next;
    next.reserve(I.size());
    for (int j : I) {
      const float l = std::max(0.f, std::min(boxes[i * 8 + 3], boxes[j * 8 + 3]) -
                                        std::max(boxes[i * 8 + 0], boxes[j * 8 + 0]));
      const float w = std::max(0.f, std::min(boxes[i * 8 + 4], boxes[j * 8 + 4]) -
                                        std::max(boxes[i * 8 + 1], boxes[j * 8 + 1]));
      const float h = std::max(0.f, std::min(boxes[i * 8 + 5], boxes[j * 8 + 5]) -
                                        std::max(boxes[i * 8 + 2], boxes[j * 8 + 2]));
      const float inter = l * w * h;
      float o = old_type ? inter / area[j] : inter / (area[i] + area[j] - inter);
      if (boxes[i * 8 + 7] != boxes[j * 8 + 7]) o = 0.f;
      if (!(o > thresh)) next.push_back(j);
    }
    I.swap(next);
  }
  return n_keep;
}

}  // extern "C"
