"""OpenCV-style YAML loader.

The reference stores every component configuration in OpenCV ``cv::FileStorage``
YAML files (reference: ``test/data/*.yml``, loaded at e.g.
``include/slam/frontend/feature_detector.hpp:53-107``).  This module reads the
subset those files use, with the standard library alone:

  * an optional ``%YAML:1.0`` directive and ``---`` document marker;
  * a top-level mapping of ``Key: value`` lines, with ``#`` comments;
  * scalars (integers, floats, ``true``/``false``, plain or quoted strings)
    and flow lists of scalars ``[a, b, ...]``, which may span lines;
  * ``!!opencv-matrix`` mappings with ``rows``/``cols``/``dt``/``data`` keys,
    which become ``np.ndarray`` (float64, shape ``(rows, cols)``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np

_DIRECTIVE_RE = re.compile(r"^%YAML[:\s]\S+\s*$")
_KEY_RE = re.compile(r"^(\s*)([A-Za-z_][\w.-]*)\s*:(.*)$")
_INT_RE = re.compile(r"^[-+]?\d+$")
_FLOAT_RE = re.compile(
    r"^[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?|\.inf|\.Inf|\.INF)$"
)
_MATRIX_TAGS = ("!!opencv-matrix", "!opencv-matrix")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        return float(text.lower().replace(".inf", "inf"))
    lowered = text.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("null", "~", ""):
        return None
    return text


def _value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        inner = text[1:-1].strip()
        return [_scalar(item) for item in inner.split(",")] if inner else []
    return _scalar(text)


def _logical_lines(lines: list[str]) -> list[tuple[int, str, str]]:
    """``(indent, key, value text)`` per entry, joining multi-line lists."""
    out: list[tuple[int, str, str]] = []
    pending: list | None = None
    for raw in lines:
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if pending is not None:
            pending[2] += " " + line.strip()
        else:
            m = _KEY_RE.match(line)
            if m is None:
                raise ValueError(f"unsupported YAML line: {raw!r}")
            pending = [len(m.group(1)), m.group(2), m.group(3).strip()]
        if pending[2].count("[") == pending[2].count("]"):
            out.append(tuple(pending))
            pending = None
    if pending is not None:
        raise ValueError(f"unterminated list for key {pending[1]!r}")
    return out


def _matrix(fields: dict[str, Any]) -> np.ndarray:
    rows, cols = int(fields["rows"]), int(fields["cols"])
    return np.asarray(fields["data"], dtype=np.float64).reshape(rows, cols)


def parse_opencv_yaml(text: str) -> dict[str, Any]:
    """Parse OpenCV FileStorage YAML text into a plain dict."""
    lines = text.splitlines()
    if lines and _DIRECTIVE_RE.match(lines[0]):
        lines = lines[1:]
    lines = [ln for ln in lines if ln.strip() != "---"]
    doc: dict[str, Any] = {}
    entries = _logical_lines(lines)
    i = 0
    while i < len(entries):
        indent, key, text = entries[i]
        if indent:
            raise ValueError(f"unexpected indented key {key!r}")
        i += 1
        if text in _MATRIX_TAGS or text == "":
            fields: dict[str, Any] = {}
            while i < len(entries) and entries[i][0] > 0:
                fields[entries[i][1]] = _value(entries[i][2])
                i += 1
            doc[key] = _matrix(fields) if text in _MATRIX_TAGS else fields
        else:
            doc[key] = _value(text)
    return doc


def load_opencv_yaml(path: str | Path) -> dict[str, Any]:
    """Load an OpenCV FileStorage YAML file into a plain dict.

    Matrices tagged ``!!opencv-matrix`` become ``np.ndarray`` (float64,
    shape ``(rows, cols)``).
    """
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"Could not open config file: {path}")
    return parse_opencv_yaml(path.read_text())
