"""Tokenizer wrapper: StarCoder-family tokenizers + StarVector special tokens
(the port's copy of starvector_tpu/models/tokenizer.py).

Rebuilds the reference's tokenizer initialization (reference:
starvector/model/llm/starcoder.py:40-53 and starcoder2.py:38-53):
  * special tokens `<svg-start>`, `<image-start>`, `<caption-start>`
    (v2 adds `<svg-end>`), plus [EOS]/[PAD] if the base tokenizer lacks them
  * v2 uses LEFT padding (starcoder2.py:53); v1 right padding
  * generation prompt is the literal string "<svg" (starcoder.py:39)
  * the `</svg>` stop criterion is token-id based (starvector_base.py:226)

Loads from a local HF checkpoint directory (tokenizer.json) — no network.
`build_test_tokenizer()` builds a tiny byte-level tokenizer for tests.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

SPECIAL_V1 = ["<svg-start>", "<image-start>", "<caption-start>"]
SPECIAL_V2 = ["<svg-start>", "<svg-end>", "<image-start>", "<caption-start>"]
EOS_FALLBACK = "[EOS]"
PAD_FALLBACK = "[PAD]"


class SVGTokenizer:
    def __init__(self, tokenizer, *, version: str = "v1",
                 padding_side: str | None = None):
        from tokenizers import Tokenizer  # noqa: F401

        self.tokenizer = tokenizer
        self.version = version
        self.padding_side = padding_side or ("left" if version == "v2" else "right")

        specials = SPECIAL_V2 if version == "v2" else SPECIAL_V1
        to_add = [s for s in specials if tokenizer.token_to_id(s) is None]
        if tokenizer.token_to_id("<|endoftext|>") is None and tokenizer.token_to_id(
            EOS_FALLBACK
        ) is None:
            to_add.append(EOS_FALLBACK)
        # add a dedicated [PAD] when the tokenizer has none (the reference
        # adds it and resizes embeddings, starcoder.py:40-53) so pad != eos
        has_dedicated_pad = any(
            tokenizer.token_to_id(c) is not None for c in (PAD_FALLBACK, "<pad>")
        )
        if not has_dedicated_pad and PAD_FALLBACK not in to_add:
            to_add.append(PAD_FALLBACK)
        if to_add:
            tokenizer.add_special_tokens(to_add)

        self.svg_start_token = "<svg-start>"
        self.svg_end_token = "<svg-end>" if version == "v2" else None
        self.image_start_token = "<image-start>"
        self.caption_start_token = "<caption-start>"
        self.prompt = "<svg"  # generation trigger (reference starcoder.py:39)

    # -- ids ----------------------------------------------------------------
    def _find_pad(self):
        # Prefer a dedicated pad token over <|endoftext|>: the reference adds
        # [PAD] distinct from eos (starcoder.py:40-53); pad == eos would make
        # id-based target masking erase the terminal EOS.
        for cand in (PAD_FALLBACK, "<pad>", "<|endoftext|>"):
            tid = self.tokenizer.token_to_id(cand)
            if tid is not None:
                return tid
        return None

    @property
    def eos_token(self) -> str:
        for cand in ("<|endoftext|>", EOS_FALLBACK):
            if self.tokenizer.token_to_id(cand) is not None:
                return cand
        raise RuntimeError("no eos token")

    @property
    def eos_token_id(self) -> int:
        return self.tokenizer.token_to_id(self.eos_token)

    @property
    def pad_token_id(self) -> int:
        tid = self._find_pad()
        assert tid is not None
        return tid

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    def token_ids(self, text: str) -> list[int]:
        return self.tokenizer.encode(text, add_special_tokens=False).ids

    def stop_sequence_ids(self, stop: str = "</svg>") -> tuple[int, ...]:
        return tuple(self.token_ids(stop))

    # -- encode / decode ----------------------------------------------------
    def __call__(
        self,
        texts: str | Sequence[str],
        *,
        max_length: int | None = None,
        add_special_tokens: bool = True,
        padding: str = "longest",
    ):
        """Returns dict with input_ids / attention_mask as int32 numpy,
        mirroring the reference _tokenize (starvector_base.py:108-118)."""
        if isinstance(texts, str):
            texts = [texts]
        encs = [self.tokenizer.encode(t, add_special_tokens=False) for t in texts]
        ids = [e.ids for e in encs]
        if add_special_tokens and self.version == "v1":
            pass  # GPT2-style tokenizers add nothing by default
        if max_length is not None:
            ids = [s[:max_length] for s in ids]
        # padding="max_length" without an explicit max_length degrades to
        # longest (HF behavior) instead of a 1-wide buffer that cannot
        # hold the rows
        if padding == "longest" or max_length is None:
            maxlen = max(len(s) for s in ids)
        else:
            maxlen = max_length
        maxlen = max(maxlen, 1)
        pad_id = self.pad_token_id
        out_ids = np.full((len(ids), maxlen), pad_id, np.int32)
        mask = np.zeros((len(ids), maxlen), np.int32)
        for i, s in enumerate(ids):
            L = len(s)
            if self.padding_side == "left":
                out_ids[i, maxlen - L :] = s
                mask[i, maxlen - L :] = 1
            else:
                out_ids[i, :L] = s
                mask[i, :L] = 1
        return {"input_ids": out_ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        return self.tokenizer.decode(ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]


def load_tokenizer(path: str, *, version: str = "v1") -> SVGTokenizer:
    """Load from a local HF checkpoint dir containing tokenizer.json."""
    from tokenizers import Tokenizer

    tok_file = os.path.join(path, "tokenizer.json")
    if not os.path.exists(tok_file):
        raise FileNotFoundError(f"{tok_file} not found (local checkpoint required)")
    return SVGTokenizer(Tokenizer.from_file(tok_file), version=version)


def build_test_tokenizer(version: str = "v1") -> SVGTokenizer:
    """Tiny byte-level BPE over ASCII for tests — deterministic, no files."""
    from tokenizers import Tokenizer, models, pre_tokenizers, decoders

    # vocab: all single bytes via ByteLevel alphabet
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {tok: i for i, tok in enumerate(sorted(alphabet))}
    vocab["<|endoftext|>"] = len(vocab)
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    return SVGTokenizer(tok, version=version)
