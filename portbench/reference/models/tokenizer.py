"""CLIP byte-pair-encoding tokenizer.

Copy of coda_neurips2023_tpu/models/tokenizer.py (pure Python, no jax), kept
as it is apart from where it finds its data: the merge table
`bpe_simple_vocab_16e6.txt.gz` ships with this package, in datasets/assets/
(a byte-identical copy of the JAX package's); `bpe_path` or the CODA_CLIP_BPE
env var override it.  Functional equivalent of the reference's SimpleTokenizer
and `clip.tokenize`: GPT-2-style byte-level BPE over a lower-cased,
whitespace-normalized string, wrapped with <|startoftext|> / <|endoftext|>
and padded to a 77-token context.  Without the `regex` package the word
pattern falls back to ASCII classes of `re`, which split ASCII text alike.
If no table can be found at all, `tokenize` falls back to a hash-bucket
tokenizer (deterministic, stable), as the JAX package does.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Optional, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    import unicodedata

    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


PACKAGED_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "datasets", "assets", "bpe_simple_vocab_16e6.txt.gz",
)


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = (
            bpe_path or os.environ.get("CODA_CLIP_BPE") or PACKAGED_BPE_PATH
        )
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "BPE vocab not found; pass bpe_path or set CODA_CLIP_BPE "
                f"(packaged copy expected at {PACKAGED_BPE_PATH})"
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        if _has_regex_module():
            import regex

            self.pat = regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                regex.IGNORECASE,
            )
        else:
            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                re.IGNORECASE,
            )

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text):
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


def _has_regex_module():
    try:
        import regex  # noqa: F401

        return True
    except ImportError:
        return False


def _fallback_tokens(text: str) -> List[int]:
    """Deterministic hash buckets for data-free runs (NOT real CLIP BPE)."""
    import hashlib

    words = whitespace_clean(text).lower().split(" ")
    out = []
    for w in words:
        h = int(hashlib.md5(w.encode()).hexdigest(), 16)
        out.append(512 + h % (VOCAB_SIZE - 1024))
    return out


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = CONTEXT_LENGTH,
    bpe_path: Optional[str] = None,
) -> np.ndarray:
    """-> (len(texts), context_length) int32, like reference clip.tokenize."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = None
    try:
        tokenizer = SimpleTokenizer(bpe_path)
    except FileNotFoundError:
        pass
    sot, eot = VOCAB_SIZE - 2, VOCAB_SIZE - 1
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = tokenizer.encode(text) if tokenizer else _fallback_tokens(text)
        toks = [sot] + toks + [eot]
        if len(toks) > context_length:  # reference truncates keeping EOT
            toks = toks[: context_length - 1] + [eot]
        result[i, : len(toks)] = toks
    return result
