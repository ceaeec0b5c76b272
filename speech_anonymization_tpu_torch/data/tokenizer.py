"""Subword tokenizer: trainable unigram LM with Viterbi encoding.

Counterpart of ``speech_anonymization_tpu/data/tokenizer.py``, a copy: the
same corpus trains the same pieces and log-probs, and both encoders (the
native library's and the Python Viterbi) give the same ids.

Replaces the reference's sentencepiece dependency (unigram, 5000 tokens —
convae.yaml:175, loaded at speechbrain_convae_train.py:590). sentencepiece
is not available in this environment, so the algorithm is implemented here:

  * training: EM over a seed vocabulary of frequent substrings (the
    standard unigram-LM procedure: E-step Viterbi/forward counts, M-step
    re-estimate piece log-probs, prune lowest-contribution pieces until the
    target vocab size);
  * encoding: Viterbi segmentation into the piece vocabulary;
  * text is pre-normalized like SentencePiece's default for LibriSpeech
    recipes: uppercase words joined by the word-boundary marker '▁'.

API mirrors what the recipes consume: encode_as_ids / decode_ids, plus
save/load of a plain-text model file. IDs 0..3 are reserved:
0=<blank/pad/unk>, 1=<bos>, 2=<eos> matching convae.yaml:121-126
(blank_index 0, bos 1, eos 2, unk 0).

``load_sentencepiece`` additionally reads a real sentencepiece ``.model``
protobuf (unigram pieces + scores) and adopts ITS id space verbatim —
required when decoding with ported reference ASR/LM checkpoints, whose
output layers are tied to the original vocabulary (a retrained vocab would
produce mismatched token ids).
"""

from __future__ import annotations

import json
import math
import os
from collections import Counter, defaultdict

_WB = "▁"  # '▁' word-boundary marker


class UnigramTokenizer:
    RESERVED = ["<unk>", "<bos>", "<eos>", "<pad>"]

    def __init__(self):
        self.pieces: list[str] = []
        self.log_probs: dict[str, float] = {}
        self._ids: dict[str, int] = {}
        self._native = None  # C++ encoder handle (native/tokenizer.cc)
        # id-space layout: trained models place pieces after the RESERVED
        # block; sentencepiece-loaded models adopt the .model's ids directly
        self._offset = len(self.RESERVED)
        self._control_ids: set[int] = set()

    # -- persistence ------------------------------------------------------------

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"pieces": self.pieces, "log_probs": self.log_probs}, f, ensure_ascii=False
            )

    def Load(self, path: str):  # noqa: N802 — sentencepiece-compatible name
        with open(path) as f:
            data = json.load(f)
        self.pieces = data["pieces"]
        self.log_probs = {k: float(v) for k, v in data["log_probs"].items()}
        self._reindex()
        return self

    load = Load

    def _reindex(self):
        self._ids = {p: i + self._offset for i, p in enumerate(self.pieces)}
        self._native = None
        self._init_native()

    def _init_native(self):
        """Bind the C++ Viterbi encoder when the native library is built."""
        import ctypes

        from .audio import _native_lib

        lib = _native_lib()
        if not lib or not self.pieces or not hasattr(lib, "satpu_tok_create"):
            return
        try:
            lib.satpu_tok_create.restype = ctypes.c_void_p
            lib.satpu_tok_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
            ]
            lib.satpu_tok_encode.restype = ctypes.c_long
            lib.satpu_tok_encode.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_long,
            ]
            arr = (ctypes.c_char_p * len(self.pieces))(
                *[p.encode("utf-8") for p in self.pieces]
            )
            lps = (ctypes.c_double * len(self.pieces))(
                *[self.log_probs.get(p, -1e9) for p in self.pieces]
            )
            handle = lib.satpu_tok_create(arr, lps, len(self.pieces))
            self._native = (lib, handle)
        except (AttributeError, OSError):
            self._native = None

    def vocab_size(self) -> int:
        return self._offset + len(self.pieces)

    get_piece_size = vocab_size

    # -- normalization -----------------------------------------------------------

    @staticmethod
    def _normalize(text: str) -> str:
        words = text.strip().upper().split()
        return "".join(_WB + w for w in words)

    # -- training -----------------------------------------------------------------

    def train(self, sentences, vocab_size: int = 5000, max_piece_len: int = 10,
              n_iters: int = 3, seed_factor: int = 4):
        """EM-trained unigram LM over the corpus."""
        corpus = Counter(self._normalize(s) for s in sentences if s.strip())
        chars = Counter()
        for sent, cnt in corpus.items():
            for ch in sent:
                chars[ch] += cnt

        # seed vocabulary: all substrings up to max_piece_len by frequency
        substr = Counter()
        for sent, cnt in corpus.items():
            n = len(sent)
            for i in range(n):
                for j in range(i + 1, min(i + max_piece_len, n) + 1):
                    substr[sent[i:j]] += cnt
        seed_size = max(vocab_size * seed_factor, len(chars) + 1)
        seed = {p for p, _ in substr.most_common(seed_size)}
        seed.update(chars)  # single chars must stay for coverage
        total = sum(substr[p] for p in seed)
        lp = {p: math.log(max(substr[p], 1) / total) for p in seed}

        for _ in range(n_iters):
            # E-step: Viterbi counts (hard EM — robust and fast)
            counts = defaultdict(float)
            for sent, cnt in corpus.items():
                for piece in self._viterbi(sent, lp, max_piece_len):
                    counts[piece] += cnt
            total = sum(counts.values()) or 1.0
            new_lp = {p: math.log(c / total) for p, c in counts.items() if c > 0}
            # keep chars alive for coverage
            floor = math.log(0.5 / total)
            for ch in chars:
                new_lp.setdefault(ch, floor)
            # M-step prune: keep top pieces by count, always keeping chars
            budget = vocab_size - len(self.RESERVED)
            ranked = sorted(new_lp.items(), key=lambda kv: kv[1], reverse=True)
            kept = dict(ranked[:budget])
            for ch in chars:
                kept.setdefault(ch, floor)
            lp = kept

        self.pieces = sorted(lp, key=lambda p: -lp[p])[: vocab_size - len(self.RESERVED)]
        self.log_probs = {p: lp[p] for p in self.pieces}
        self._reindex()
        return self

    @staticmethod
    def _viterbi(sent: str, lp: dict[str, float], max_piece_len: int) -> list[str]:
        n = len(sent)
        best = [0.0] + [-math.inf] * n
        back = [0] * (n + 1)
        for j in range(1, n + 1):
            for i in range(max(0, j - max_piece_len), j):
                piece = sent[i:j]
                score = lp.get(piece)
                if score is None:
                    if j - i == 1:
                        score = -100.0  # unknown char fallback
                    else:
                        continue
                cand = best[i] + score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = i
        out = []
        j = n
        while j > 0:
            i = back[j]
            out.append(sent[i:j])
            j = i
        out.reverse()
        return out

    # -- encode / decode -----------------------------------------------------------

    def encode_as_ids(self, text: str) -> list[int]:
        sent = self._normalize(text)
        if not sent:
            return []
        if self._native is not None:
            import ctypes

            lib, handle = self._native
            out = (ctypes.c_int * (len(sent) + 1))()
            m = lib.satpu_tok_encode(handle, sent.encode("utf-8"), out, len(sent) + 1)
            off = self._offset
            return [out[i] + off if out[i] >= 0 else 0 for i in range(m)]
        pieces = self._viterbi(sent, self.log_probs, max(len(p) for p in self.pieces) if self.pieces else 1)
        return [self._ids.get(p, 0) for p in pieces]

    def encode_as_pieces(self, text: str) -> list[str]:
        sent = self._normalize(text)
        if not sent:
            return []
        return self._viterbi(sent, self.log_probs, max(len(p) for p in self.pieces) if self.pieces else 1)

    def decode_ids(self, ids) -> str:
        rev = {i + self._offset: p for i, p in enumerate(self.pieces)}
        text = "".join(
            rev.get(int(i), "") for i in ids if int(i) not in self._control_ids
        )
        return text.replace(_WB, " ").strip()

    # -- sentencepiece .model interop ----------------------------------------------

    def load_sentencepiece(self, path: str):
        """Load a real sentencepiece ``.model`` protobuf (unigram), adopting
        its id space verbatim (piece index == token id, control pieces at
        their original positions). Needed so ported reference ASR/LM
        checkpoints (reference convae.yaml:316 tokenizer.ckpt) decode with
        matching token ids. Only the wire fields used by unigram inference
        are read: ModelProto.pieces (field 1) -> SentencePiece{piece=1,
        score=2, type=3}."""
        with open(path, "rb") as f:
            data = f.read()
        pieces, scores, types = _parse_spm_model(data)
        self.pieces = pieces
        self._offset = 0
        # control/unknown/unused pieces never participate in segmentation
        self.log_probs = {
            p: s for p, s, t in zip(pieces, scores, types) if t in (1, 4, 6)
        }
        self._control_ids = {
            i for i, t in enumerate(types) if t not in (1, 4, 6)
        }
        self._reindex()
        return self


def _parse_spm_model(data: bytes):
    """Minimal protobuf wire-format parser for sentencepiece ModelProto."""
    import struct as _struct

    def read_varint(buf, i):
        result = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result, i
            shift += 7

    def skip(buf, i, wire):
        if wire == 0:
            _, i = read_varint(buf, i)
        elif wire == 1:
            i += 8
        elif wire == 2:
            n, i = read_varint(buf, i)
            i += n
        elif wire == 5:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        return i

    def parse_piece(buf):
        piece, score, ptype = "", 0.0, 1  # type defaults to NORMAL
        i = 0
        while i < len(buf):
            tag, i = read_varint(buf, i)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:
                n, i = read_varint(buf, i)
                piece = buf[i : i + n].decode("utf-8")
                i += n
            elif field == 2 and wire == 5:
                (score,) = _struct.unpack("<f", buf[i : i + 4])
                i += 4
            elif field == 3 and wire == 0:
                ptype, i = read_varint(buf, i)
            else:
                i = skip(buf, i, wire)
        return piece, score, ptype

    pieces, scores, types = [], [], []
    i = 0
    while i < len(data):
        tag, i = read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # ModelProto.pieces
            n, i = read_varint(data, i)
            p, s, t = parse_piece(data[i : i + n])
            i += n
            pieces.append(p)
            scores.append(float(s))
            types.append(int(t))
        else:
            i = skip(data, i, wire)
    if not pieces:
        raise ValueError("no sentencepiece pieces found (not a .model file?)")
    return pieces, scores, types
