"""The rest of the PyTorch port's CLIP against the JAX package on the CPU: the
learned-prompt text path (`_insert_prompt_embeddings`,
`encode_text_with_prompt_embedding`) and `preprocess_images`.

Inputs are made from seeds with numpy; flax weights reach the port through
`utils.weights.clip_state_dict_from_flax`.  Tolerances, each with its reason:

  * `_insert_prompt_embeddings`: exact (a gather and two selects, no
    arithmetic), against the JAX function and against
    tests/test_prompt_text.py's numpy transcription of the reference's loop;
  * the prompted text tower: 1e-5 (fp32, one layer of width 32: XLA's and
    PyTorch's matmuls sum in different orders, outputs O(0.1)-O(1));
  * `preprocess_images`: 1e-4 on CLIP-normalized values of O(1)-O(10)
    (the resize's two fp32 contractions of up to ~20 taps of values in
    [0, 255] in different orders, then / 255 / 0.26).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu.models import clip as jclip

from coda_neurips2023_tpu_torch.models import clip as tclip
from coda_neurips2023_tpu_torch.utils.weights import clip_state_dict_from_flax, to_torch

from test_prompt_text import reference_insert
from torch_one_thread import one_intra_op_thread  # noqa: F401

PROMPT_TOL = 1e-5
PREPROCESS_TOL = 1e-4
TEXT_CLIP = dict(embed_dim=16, image_resolution=16, vision_patch_size=8, vision_width=64,
                 vision_layers=1, text_width=32, text_layers=1, text_heads=2,
                 context_length=16, vocab_size=64)


def _tokens(rng, b, seq_len, lengths, eot):
    """Rows [SOT, name tokens, EOT, padding] of the given lengths (with SOT
    and EOT), EOT the highest id."""
    tokens = np.zeros((b, seq_len), np.int32)
    for i, lt in enumerate(lengths):
        tokens[i, 0] = 1
        tokens[i, 1:lt - 1] = rng.integers(2, eot, lt - 2)
        tokens[i, lt - 1] = eot
    return tokens


PROMPTS = [(2, 3), (2, 0), (0, 3), (0, 0), (1, 1)]


@pytest.mark.parametrize("lf,ll", PROMPTS)
def test_insert_prompt_embeddings_matches_jax_and_the_reference_loop(lf, ll):
    rng = np.random.default_rng(lf * 10 + ll)
    b, seq_len, w = 4, 16, 8
    x = rng.standard_normal((b, seq_len, w)).astype(np.float32)
    tokens = _tokens(rng, b, seq_len, [3, 4, 7, 10], 99)
    former = rng.standard_normal((lf, w)).astype(np.float32) if lf else None
    later = rng.standard_normal((ll, w)).astype(np.float32) if ll else None
    as_j = lambda a: None if a is None else jnp.asarray(a)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    want = np.asarray(jclip._insert_prompt_embeddings(as_j(x), as_j(tokens), as_j(former),
                                                      as_j(later)))
    got = tclip._insert_prompt_embeddings(torch.from_numpy(x), torch.from_numpy(tokens).long(),
                                          as_t(former), as_t(later)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reference_insert(x, tokens, former, later))


@pytest.fixture(scope="module")
def text_clip():
    jm = jclip.CLIP(**TEXT_CLIP)
    imgs = jnp.zeros((1, 16, 16, 3))
    toks = jnp.zeros((1, TEXT_CLIP["context_length"]), jnp.int32)
    params = jm.init(jax.random.PRNGKey(3), imgs, toks)["params"]
    tm = tclip.CLIP(**TEXT_CLIP)
    tm.load_state_dict(to_torch(clip_state_dict_from_flax(params)), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("lf,ll", PROMPTS)
def test_encode_text_with_prompt_embedding_matches_jax(text_clip, lf, ll):
    """The pooling keeps the reference quirk: the original EOT position."""
    jm, params, tm = text_clip
    rng = np.random.default_rng(20 + lf * 10 + ll)
    w = TEXT_CLIP["text_width"]
    tokens = _tokens(rng, 3, TEXT_CLIP["context_length"], [3, 6, 9], 63)
    former = rng.standard_normal((lf, w)).astype(np.float32) if lf else None
    later = rng.standard_normal((ll, w)).astype(np.float32) if ll else None
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    None if former is None else jnp.asarray(former),
                    None if later is None else jnp.asarray(later),
                    method=jm.encode_text_with_prompt_embedding)
    with torch.inference_mode():
        got = tm.encode_text_with_prompt_embedding(
            torch.from_numpy(tokens).long(), None if former is None else torch.from_numpy(former),
            None if later is None else torch.from_numpy(later))
        plain = tm.encode_text(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROMPT_TOL)
    if lf or ll:
        assert not torch.allclose(got, plain)
    else:
        assert torch.equal(got, plain)


@pytest.mark.parametrize("hw,res", [
    ((40, 60), 32),    # wide, shrunk
    ((70, 30), 32),    # tall, shrunk
    ((20, 28), 32),    # wide, grown
    ((27, 19), 32),    # tall, grown
    ((32, 45), 32),    # the short side already at the resolution
    ((531, 730), 224),  # a padded SUN RGB-D image
])
def test_preprocess_images_matches_jax(hw, res):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    images = rng.uniform(0.0, 255.0, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jclip.preprocess_images(jnp.asarray(images), res))
    got = tclip.preprocess_images(torch.from_numpy(images), res)
    assert got.shape == want.shape == (2, res, res, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREPROCESS_TOL)
    # uint8 input, as the reference's tensors arrive
    as_u8 = torch.from_numpy(images.astype(np.uint8))
    want8 = np.asarray(jclip.preprocess_images(jnp.asarray(images.astype(np.uint8)), res))
    np.testing.assert_allclose(tclip.preprocess_images(as_u8, res).numpy(), want8, rtol=0,
                               atol=PREPROCESS_TOL)
