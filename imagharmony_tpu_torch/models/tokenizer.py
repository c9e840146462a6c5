"""Pure-Python CLIP BPE tokenizer (torch/transformers-free).

Replaces the reference's CLIPTokenizer dependency (reference
train.py:506-508, tokenization at train.py:107-138). Host-side only —
token ids are the device boundary, so there is nothing to accelerate here;
the value is a dependency-free, deterministic implementation that matches
HF's CLIPTokenizer output (validated in tests/test_tokenizer.py).

Vocab files are the standard ``vocab.json`` + ``merges.txt`` shipped with
every SD/SDXL checkpoint directory.
"""

from __future__ import annotations

import functools
import json
import os

try:  # full unicode-category pattern when `regex` is present (it is, via transformers)
    import regex as _re

    _PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is a baked-in transitive dep
    import re as _re

    _PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        _re.IGNORECASE,
    )

import re

_WHITESPACE = re.compile(r"\s+")


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2/CLIP reversible byte→unicode map (printable chars only)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    def __init__(
        self,
        vocab: dict,
        merges: list,
        *,
        bos_token="<|startoftext|>",
        eos_token="<|endoftext|>",
        pad_token=None,
        model_max_length=77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        pad = pad_token if pad_token is not None else eos_token
        self.pad_token_id = self.encoder[pad]
        self.model_max_length = model_max_length
        self._cache = {bos_token: bos_token, eos_token: eos_token}
        # literal tokens that bypass BPE, each expanding to a list of ids
        # (textual-inversion placeholders; multi-vector embeddings expand
        # to several consecutive ids)
        self.added_tokens: dict = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_files(cls, vocab_json, merges_txt, **kw):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is the "#version" header; trailing blanks dropped
        merges = [tuple(l.split()) for l in lines[1 : 49152 - 256 - 2 + 1] if l.strip()]
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained_dir(cls, path, **kw):
        """Load from an SD/SDXL checkpoint subfolder (tokenizer/ or
        tokenizer_2/)."""
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    # -- BPE --------------------------------------------------------------

    def _bpe(self, token):
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def tokenize(self, text):
        text = _WHITESPACE.sub(" ", text).strip().lower()
        out = []
        for tok in _PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(tok).split(" "))
        return out

    def add_token(self, name, ids):
        """Register a literal token that bypasses BPE and expands to
        ``ids`` — the textual-inversion placeholder mechanism (HF
        added-tokens role; a multi-vector embedding's single prompt token
        expands to its n consecutive ids, diffusers
        maybe_convert_prompt semantics). Lower-case names only — CLIP
        tokenization lowercases its input."""
        if name != name.lower():
            raise ValueError(f"added tokens must be lower-case, got {name!r}")
        if name in self.encoder:
            raise ValueError(f"token {name!r} already in the vocab")
        self.added_tokens[name] = [int(i) for i in ids]

    def _segments(self, text):
        """Split normalized text into (segment, ids|None) pieces around the
        added tokens (longest-first, so overlapping names resolve to the
        most specific)."""
        if not self.added_tokens:
            return [(text, None)]
        pat = re.compile(
            "(" + "|".join(
                re.escape(t)
                for t in sorted(self.added_tokens, key=len, reverse=True)
            ) + ")"
        )
        return [
            (part, self.added_tokens.get(part))
            for part in pat.split(text) if part
        ]

    def encode(self, text, *, pad_to_max=True, max_length=None):
        """text -> list of ids: [BOS] tokens [EOS] (+ padding).

        Truncation keeps EOS as the final token (HF CLIPTokenizer
        truncation=True semantics the reference relies on,
        train.py:107-113)."""
        max_length = max_length or self.model_max_length
        text = _WHITESPACE.sub(" ", text).strip().lower()
        ids = []
        for seg, seg_ids in self._segments(text):
            if seg_ids is not None:
                ids.extend(seg_ids)
            else:
                ids.extend(self.encoder[t] for t in self.tokenize(seg))
        ids = [self.bos_token_id] + ids[: max_length - 2] + [self.eos_token_id]
        if pad_to_max and len(ids) < max_length:
            ids = ids + [self.pad_token_id] * (max_length - len(ids))
        return ids

    def encode_batch(self, texts, **kw):
        import numpy as np

        return np.asarray([self.encode(t, **kw) for t in texts], dtype=np.int32)

    def decode(self, ids, *, skip_special=True):
        added_rev = {
            i: name + "</w>"
            for name, ids_ in self.added_tokens.items() for i in ids_
        }
        toks = [
            self.decoder[int(i)] if int(i) in self.decoder
            else added_rev[int(i)]
            for i in ids
        ]
        if skip_special:
            toks = [t for t in toks if t not in (self.bos_token, self.eos_token)]
        text = "".join(toks)
        return (
            bytearray([self.byte_decoder[c] for c in text])
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )


def build_toy_tokenizer(words=("a", "dog", "cat", "sheep", "photo", "of", "eight", "six")):
    """Tiny synthetic vocab for tests/demos (no checkpoint needed)."""
    byte_vocab = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(byte_vocab)}
    for c in byte_vocab:
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for w in words:
        # merge letters left-to-right: (a b), (ab c), ...
        acc = w[0]
        for ch in w[1:-1] if len(w) > 1 else []:
            merges.append((acc, ch))
            acc += ch
            vocab.setdefault(acc, len(vocab))
        if len(w) > 1:
            merges.append((acc, w[-1] + "</w>"))
        vocab.setdefault(w + "</w>", len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, merges)


class SDXLTokenizers:
    """The dual-tokenizer front end (reference train.py:506-508): tower 1
    pads with EOS, tower 2 pads with '!' (id 0 in the OpenCLIP vocab)."""

    def __init__(self, tok1: CLIPTokenizer, tok2: CLIPTokenizer):
        self.tok1 = tok1
        self.tok2 = tok2

    @classmethod
    def from_pretrained_dir(cls, model_dir):
        return cls(
            CLIPTokenizer.from_pretrained_dir(os.path.join(model_dir, "tokenizer")),
            CLIPTokenizer.from_pretrained_dir(
                os.path.join(model_dir, "tokenizer_2"), pad_token="!"
            ),
        )

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        return self.tok1.encode_batch(texts), self.tok2.encode_batch(texts)
