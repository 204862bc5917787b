"""SentencePiece-style vocab tokenizer.

Behavioral parity with the reference Tokenizer (src/vocab.cpp:10-117):
  * load: one piece per line, optional ``\\tscore`` suffix (SentencePiece
    .vocab format); id = line index. Blank lines without a tab are skipped.
  * decode: concat pieces, ``▁`` (U+2581) → space, strip ONE leading space,
    out-of-range id → ``[id]``.
  * encode: prepend ``▁``, spaces → ``▁``, greedy longest-match over the
    piece table, unknown bytes skipped.

Pure host-side Python; no JAX.
"""

from __future__ import annotations

from pathlib import Path

SP_MARKER = "▁"  # ▁ SentencePiece word-boundary marker


class Tokenizer:
    def __init__(self, vocab_path: str | Path | None = None):
        self._pieces: list[str] = []
        self._piece_to_id: dict[bytes, int] | None = None
        self._max_piece_len = 0
        if vocab_path is not None:
            self.load(vocab_path)

    # ── Loading ──────────────────────────────────────────────────────────

    def load(self, vocab_path: str | Path) -> None:
        path = Path(vocab_path)
        if not path.is_file():
            raise FileNotFoundError(f"Cannot open vocab file: {path}")
        pieces: list[str] = []
        # SentencePiece vocabs may contain raw-byte pieces; decode leniently.
        with open(path, encoding="utf-8", errors="surrogateescape") as f:
            for line in f.read().splitlines():
                tab = line.find("\t")
                if tab != -1:
                    pieces.append(line[:tab])
                elif line:
                    pieces.append(line)
        self._pieces = pieces
        self._piece_to_id = None
        self._max_piece_len = 0

    def load_pieces(self, pieces: list[str]) -> None:
        """Load directly from an in-memory piece list (tests, conversion)."""
        self._pieces = list(pieces)
        self._piece_to_id = None
        self._max_piece_len = 0

    @property
    def loaded(self) -> bool:
        return bool(self._pieces)

    @property
    def pieces(self) -> list[str]:
        return self._pieces

    def vocab_size(self) -> int:
        return len(self._pieces)

    # ── Decode ───────────────────────────────────────────────────────────

    def decode(self, token_ids) -> str:
        parts: list[str] = []
        n = len(self._pieces)
        for tid in token_ids:
            tid = int(tid)
            if tid < 0 or tid >= n:
                parts.append(f"[{tid}]")
            else:
                parts.append(self._pieces[tid])
        out = "".join(parts).replace(SP_MARKER, " ")
        if out.startswith(" "):
            out = out[1:]
        return out

    def id_to_piece(self, tid: int) -> str:
        return self._pieces[tid]

    # ── Encode ───────────────────────────────────────────────────────────

    def _build_encode_table(self) -> None:
        if self._piece_to_id is not None:
            return
        # Match on raw BYTES, exactly like the reference (vocab.cpp indexes
        # std::string bytes): pieces loaded with surrogateescape round-trip
        # back to their original bytes, so raw-byte vocab entries match
        # byte-substrings of the input instead of never matching a whole
        # code point, and the no-match skip advances one byte, not one char.
        table: dict[bytes, int] = {}
        max_len = 0
        for i, piece in enumerate(self._pieces):
            # Duplicates: LAST occurrence wins, matching the reference's
            # `map[piece] = id` assignment semantics (vocab.cpp operator[]).
            pb = piece.encode("utf-8", "surrogateescape")
            table[pb] = i
            if len(pb) > max_len:
                max_len = len(pb)
        self._piece_to_id = table
        self._max_piece_len = max_len

    def encode(self, text: str) -> list[int]:
        if not self._pieces or not text:
            return []
        self._build_encode_table()
        assert self._piece_to_id is not None

        # Prepend ▁ and replace spaces with ▁ (vocab.cpp:81-90).
        chars = [SP_MARKER]
        for c in text:
            chars.append(SP_MARKER if c == " " else c)
        inp = "".join(chars)

        data = inp.encode("utf-8", "surrogateescape")  # byte-level matching
        result: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            best_id = -1
            best_len = 0
            for length in range(min(self._max_piece_len, n - pos), 0, -1):
                tid = self._piece_to_id.get(data[pos : pos + length])
                if tid is not None:
                    best_id, best_len = tid, length
                    break
            if best_id >= 0:
                result.append(best_id)
                pos += best_len
            else:
                pos += 1  # skip unknown byte (vocab.cpp:104-112)
        return result


__all__ = ["Tokenizer", "SP_MARKER"]
