"""Tokenizer: the byte-level tokenizer of
``nanodiloco_tpu/data/tokenizer.py``, copied (the JAX package's
``__init__`` imports JAX, so the port keeps its own copy). The HF
tokenizer wrapper is not ported yet, so ``get_tokenizer`` knows the
byte-level tokenizer alone."""

from __future__ import annotations

from typing import Protocol


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes; 256=pad, 257=bos,
    258=eos. Vocab padded to 384 (a multiple of 128)."""

    vocab_size = 384
    pad_id = 256
    bos_id = 257
    eos_id = 258

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


BYTE_TOKENIZER_NAMES = (None, "byte-level")  # as train() records it, and its manifest name


def get_tokenizer(name: str | None = None) -> ByteTokenizer:
    """The tokenizer a checkpoint's sidecar names (None: the byte-level
    one). Any other name raises a readable SystemExit: the HF tokenizer
    wrapper is not ported yet (ROADMAP.md, Queue A), and serving a model
    through the wrong vocabulary would decode garbage."""
    if name in BYTE_TOKENIZER_NAMES:
        return ByteTokenizer()
    raise SystemExit(
        f"tokenizer {name!r} is not available in nanodiloco_tpu_torch: only the "
        "byte-level tokenizer is ported (the HF tokenizer wrapper is not, "
        "ROADMAP.md Queue A)"
    )
