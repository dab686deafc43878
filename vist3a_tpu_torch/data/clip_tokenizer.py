r"""CLIP byte-level BPE tokenizer (pure Python, offline).

Port of `vist3a_tpu/data/clip_tokenizer.py`.  The reference tokenizes the
prompts of PickScore through HF `CLIPTokenizer` (`utils/reward.py:33-37,
152-157`), of DFN5B through `open_clip.get_tokenizer` (:43-47, 171-174) and
of CLIPScore / LongCLIP through torchmetrics (`evaluation/gen_eval/
t3_scene_evaluation.py:96-119`): all the byte-level BPE of openai/CLIP's
`simple_tokenizer.py`, built here from checkpoint-local files
(`vocab.json` + `merges.txt`, or the single openai
`bpe_simple_vocab_16e6.txt(.gz)` merges file).  `fix_text` is the ftfy
subset open_clip exercises: HTML unescape twice, UTF-8-read-as-cp1252
repair (up to twice), NFC.

The JAX module splits text with the `regex` package's pattern
`<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|
[^\s\p{L}\p{N}]+` (IGNORECASE).  The port needs no `regex`: `_pre_tokens`
scans the same alternatives in the same order, `\p{L}` and `\p{N}` from
`unicodedata.category` (every L* and every N* category: `²`, `Ⅻ` and `½`
are numbers), `\s` as `str.isspace` less U+001C-U+001F (which `regex`'s
`\s` leaves out), and the literals matched case-insensitively as `regex`
folds them (`ſ` matches `s`).  It gives `regex`'s tokens for every
character that Python's `unicodedata` knows; a character assigned in a
later Unicode version than it has is neither letter nor number here.
"""

from __future__ import annotations

import functools
import gzip
import json
import re
import unicodedata

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve",
             "'m", "'ll", "'d")
# IGNORECASE as `regex` folds the literals' letters (simple case folding;
# the text is lower-cased before the split)
_FOLD = str.maketrans({"ſ": "s"})
_NOT_SPACE = "\x1c\x1d\x1e\x1f"


def _is_space(ch: str) -> bool:
    return ch.isspace() and ch not in _NOT_SPACE


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _pre_tokens(text: str) -> list[str]:
    """The JAX module's `regex.findall(_PAT, text)`: at each position the
    first alternative that matches, in the pattern's order; a position
    where none does (whitespace) is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        lit = next((t for t in _LITERALS
                    if text[i:i + len(t)].lower().translate(_FOLD) == t),
                   None)
        if lit is not None:
            j = i + len(lit)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not _is_space(ch):
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """GPT-2 reversible byte→unicode map (printable, no whitespace/control)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    r"""`regex.sub(r"\s+", " ", text).strip()`."""
    out, space = [], False
    for ch in text:
        if _is_space(ch):
            space = True
            continue
        if space:
            out.append(" ")
            space = False
        out.append(ch)
    if space:
        out.append(" ")
    return "".join(out).strip()


# Typical lead characters of UTF-8 bytes mis-decoded as cp1252/latin-1:
# Ã/Â (0xC3/0xC2), â (0xE2, opens punctuation like â€œ), plus the cp1252
# mappings of UTF-8 continuation bytes (€‚ƒ„…†‡ˆ‰Š‹ŒŽ‘’“”•–—˜™š›œžŸ).
_MOJIBAKE_HINT = re.compile("[ÃÂâ€œ“”™]")


def _encode_sloppy_cp1252(s: str) -> bytes | None:
    """cp1252 encode with the 5 unassigned bytes taken from latin-1 (ftfy's
    'sloppy-windows-1252'); None if any char has no single-byte form."""
    out = bytearray()
    for ch in s:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            o = ord(ch)
            if o > 0xFF:
                return None
            out.append(o)
    return bytes(out)


def fix_text(text: str) -> str:
    """Minimal ftfy equivalent (see module docstring): html unescape ×2,
    UTF-8-as-cp1252 mojibake repair (≤2 rounds), NFC normalization."""
    import html

    text = html.unescape(html.unescape(text))
    for _ in range(2):
        if not _MOJIBAKE_HINT.search(text):
            break
        raw = _encode_sloppy_cp1252(text)
        if raw is None:
            break
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            break
        if fixed == text:
            break
        text = fixed
    return unicodedata.normalize("NFC", text)


class CLIPTokenizer:
    """encode(text) → BPE ids; __call__ batches/pads to a context length.

    vocab: token string → id (word-final tokens carry the '</w>' marker).
    merges: ordered list of merge pairs (rank = priority).
    """

    def __init__(self, vocab: dict, merges: list):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache = {SOT: SOT, EOT: EOT}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    # ---- constructors ---------------------------------------------------- #
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "CLIPTokenizer":
        """HF layout: `vocab.json` + `merges.txt` (first line is a header)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        return cls(vocab, merges)

    @classmethod
    def from_openai_merges(cls, path: str) -> "CLIPTokenizer":
        """openai layout: single `bpe_simple_vocab_16e6.txt(.gz)`; the vocab
        is derived from the byte alphabet + merges in the canonical order."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines[1:48894 + 1] if l]
        alphabet = list(bytes_to_unicode().values())
        tokens = alphabet + [c + "</w>" for c in alphabet]
        tokens += ["".join(m) for m in merges]
        tokens += [SOT, EOT]
        return cls({t: i for i, t in enumerate(tokens)}, merges)

    # ---- BPE ------------------------------------------------------------- #
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list:
        """Text → BPE ids, no special tokens."""
        text = _whitespace_clean(fix_text(text)).lower()
        ids = []
        for token in _pre_tokens(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # ---- batching -------------------------------------------------------- #
    def __call__(self, texts, context_length: int = 77, *,
                 pad: str = "zero") -> np.ndarray:
        """[SOT] + bpe + [EOT], truncated (EOT kept as the final token, the
        openai `clip.tokenize(truncate=True)` convention) and padded to
        `context_length`.  pad='zero' (open_clip) or 'eos' (HF CLIP, whose
        pad token is EOT).  argmax-EOS pooling in `nn.clip.text_features`
        is correct under both (argmax returns the first occurrence)."""
        if isinstance(texts, str):
            texts = [texts]
        pad_id = {"zero": 0, "eos": self.eot_id}[pad]
        out = np.full((len(texts), context_length), pad_id, np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length - 1] + [self.eot_id]
            out[r, :len(ids)] = ids
        return out
