"""Streaming edge-list parsers (SNAP / TSV / CSV, plain or gzip); a copy
of the JAX package's ``ingest/parse.py``.

The contract is STREAMING: the text is read through a bounded buffer
(line iteration over a possibly-gzip-wrapped binary stream) and handed
out as fixed-size numpy chunks — a multi-GB edge list never
materializes as one string or one list.  Id dtype is sniffed from the
first data line: all-numeric files yield int64 chunks (SNAP graphs use
ids far beyond int32 — the dense mapping happens later, in
``idmap.NodeIdMapping``), anything else yields string chunks.

Format rules (SNAP conventions):
- lines starting with a comment prefix (default ``#`` or ``%``) and
  blank lines are skipped anywhere in the file;
- each data line is ``src <delim> dst [extra columns ignored]`` —
  SNAP files often carry weights/timestamps in columns 3+;
- ``delimiter=None`` splits on any whitespace run (tabs or spaces);
  pass e.g. ``","`` for CSV-ish exports.

Malformed lines raise :class:`ParseError` with the 1-based line number
— a truncated download must fail loudly, not load a half graph.
"""
from __future__ import annotations

import gzip
import io
from typing import Iterator, Optional, Sequence

import numpy as np

GZIP_MAGIC = b"\x1f\x8b"
DEFAULT_COMMENTS = ("#", "%")
DEFAULT_CHUNK_EDGES = 1 << 16


class ParseError(ValueError):
    """Malformed edge-list input (carries file context + line number)."""


def _open_text(source):
    """``source`` -> (text-mode iterable, needs_close, display name).

    Accepts a path (str/``os.PathLike``; gzip sniffed from magic
    bytes, not the extension) or an already-open file object (binary
    or text)."""
    if hasattr(source, "read"):
        name = getattr(source, "name", "<stream>")
        first = source.read(0)
        if isinstance(first, bytes):
            buf = source if hasattr(source, "peek") else \
                io.BufferedReader(source)
            if buf.peek(2)[:2] == GZIP_MAGIC:
                buf = gzip.open(buf, "rb")
            return io.TextIOWrapper(buf, encoding="utf-8"), False, name
        return source, False, name
    path = str(source)
    raw = io.open(path, "rb")
    if raw.peek(2)[:2] == GZIP_MAGIC:
        return io.TextIOWrapper(gzip.open(raw, "rb"),
                                encoding="utf-8"), True, path
    return io.TextIOWrapper(raw, encoding="utf-8"), True, path


def _to_int64(tokens: list, start_line: int, name: str) -> np.ndarray:
    try:
        return np.array(tokens, dtype=np.int64)
    except (ValueError, OverflowError):
        for i, t in enumerate(tokens):     # slow path: name the culprit
            try:
                int(t)
            except ValueError:
                raise ParseError(
                    f"{name}: line {start_line + i}: non-numeric id "
                    f"{t!r} in a numeric edge list (first data line "
                    "was numeric — mixed id types are not supported)"
                    ) from None
        raise


def iter_edge_chunks(source, *, delimiter: Optional[str] = None,
                     comments: Sequence[str] = DEFAULT_COMMENTS,
                     chunk_edges: int = DEFAULT_CHUNK_EDGES,
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(src, dst)`` external-id chunks of at most
    ``chunk_edges`` edges each (int64 for numeric files, unicode
    otherwise — both sides always share one dtype)."""
    if chunk_edges < 1:
        raise ValueError(f"chunk_edges must be >= 1; got {chunk_edges}")
    text, needs_close, name = _open_text(source)
    prefixes = tuple(comments)
    numeric: Optional[bool] = None
    srcs: list = []
    dsts: list = []
    lines: list = []          # 1-based line number per buffered edge

    def emit():
        if numeric:
            s = _to_int64(srcs, lines[0], name)
            d = _to_int64(dsts, lines[0], name)
        else:
            s, d = np.array(srcs, dtype=str), np.array(dsts, dtype=str)
        srcs.clear(), dsts.clear(), lines.clear()
        return s, d

    try:
        for lineno, line in enumerate(text, start=1):
            t = line.strip()
            if not t or (prefixes and t.startswith(prefixes)):
                continue
            fields = t.split(delimiter)
            # empty strings from repeated explicit delimiters ("a,,b")
            if delimiter is not None:
                fields = [f for f in fields if f]
            if len(fields) < 2:
                raise ParseError(
                    f"{name}: line {lineno}: expected at least 2 "
                    f"fields (src, dst), got {len(fields)}: {t!r}")
            if numeric is None:            # sniff dtype once, first line
                numeric = True
                for f in fields[:2]:
                    try:
                        int(f)
                    except ValueError:
                        numeric = False
            srcs.append(fields[0])
            dsts.append(fields[1])
            lines.append(lineno)
            if len(srcs) >= chunk_edges:
                yield emit()
        if srcs:
            yield emit()
    finally:
        if needs_close:
            text.close()


def read_edge_list(source, **kw) -> tuple[np.ndarray, np.ndarray]:
    """Convenience: concatenate every chunk (small files / tests).
    Returns empty int64 arrays for an edge-free file."""
    chunks = list(iter_edge_chunks(source, **kw))
    if not chunks:
        empty = np.array([], dtype=np.int64)
        return empty, empty.copy()
    return (np.concatenate([s for s, _ in chunks]),
            np.concatenate([d for _, d in chunks]))
