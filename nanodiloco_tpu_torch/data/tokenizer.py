"""Tokenizers: a copy of ``nanodiloco_tpu/data/tokenizer.py`` (the JAX
package's ``__init__`` imports JAX, so the port keeps its own): the
byte-level tokenizer, ``HFTokenizer`` over a ``transformers`` tokenizer
(imported when one is built, and read from local files only: nothing is
downloaded), and ``get_tokenizer``, which gives the HF tokenizer when it
loads and the byte-level one, with a warning, when it does not.
``load_tokenizer`` is the strict form that generation and serving use:
a model trained on a named vocabulary must not be decoded through
another."""

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


class HFTokenizer:
    """Wrapper over a ``transformers`` tokenizer, with the reference's
    pad-token choice (the EOS token, else ``</s>``)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        if self._tok.pad_token is None:
            self._tok.pad_token = self._tok.eos_token or "</s>"
        self.vocab_size = len(self._tok)
        self.pad_id = self._tok.pad_token_id
        self.eos_id = self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=add_bos)
        if add_eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        return self._tok.decode(list(ids))


BYTE_TOKENIZER_NAMES = (None, "byte-level")  # as train() records it, and its manifest name


def get_tokenizer(name_or_path: str | None = None) -> Tokenizer:
    """The HF tokenizer ``name_or_path`` names when it loads from local
    files, else the byte-level one. A failed explicit request falls back
    with a warning: a silent vocabulary switch would corrupt a run
    invisibly."""
    if name_or_path not in BYTE_TOKENIZER_NAMES:
        try:
            return HFTokenizer(name_or_path)
        except Exception as e:
            import warnings

            warnings.warn(
                f"could not load tokenizer {name_or_path!r} ({type(e).__name__}: {e}); "
                "falling back to the 384-token byte-level tokenizer",
                stacklevel=2,
            )
    return ByteTokenizer()


def load_tokenizer(name_or_path: str | None = None) -> Tokenizer:
    """The tokenizer a checkpoint's sidecar names, or a readable
    SystemExit when it cannot load: weights trained on that vocabulary
    would decode garbage through the byte-level fallback."""
    if name_or_path in BYTE_TOKENIZER_NAMES:
        return ByteTokenizer()
    try:
        return HFTokenizer(name_or_path)
    except Exception as e:
        raise SystemExit(
            f"tokenizer {name_or_path!r} is not available: {type(e).__name__}: {e} "
            "(HF tokenizers load from local files and need the transformers package; "
            "the checkpoint was trained on that vocabulary, so the byte-level "
            "fallback would decode garbage)"
        ) from e
