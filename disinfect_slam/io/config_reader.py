"""Camera config parsing: intrinsics, depth factor, extrinsics.

Mirrors utils/config_reader.hpp:13-30 and the camera YAML layout in
configs/*.yaml (Camera.fx/.fy/.cx/.cy, depthmap_factor, Extrinsics as a
row-major 4x4).
"""

from __future__ import annotations

import re

import numpy as np

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")


def _scalar(text: str):
    """One YAML scalar of the camera-config subset: int, float, bool,
    null, or a (possibly quoted) string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if _INT.match(t):
        return int(t)
    if _FLOAT.match(t):
        return float(t)
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    return t


def _strip_comment(line: str) -> str:
    """Drop a '#' comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    """The YAML subset the repo's camera configs use: flat `key: scalar`
    lines, `[...]` flow lists of scalars that may span lines, and `#`
    comments.  Anything else (nesting, block lists, anchors) raises."""
    out: dict = {}
    pending_key, pending = None, ""
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if pending_key is not None:
            pending += " " + line.strip()
        elif not line.strip() or line.strip() == "---":
            continue
        else:
            if line[0] in " \t" or ":" not in line:
                raise ValueError(f"unsupported YAML at line {lineno}: {raw!r}")
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if not value.startswith("["):
                out[key] = _scalar(value)
                continue
            pending_key, pending = key, value
        if pending.endswith("]"):
            body = pending[1:-1].strip()
            out[pending_key] = [_scalar(v) for v in body.split(",")] if body else []
            pending_key, pending = None, ""
    if pending_key is not None:
        raise ValueError(f"unterminated list for key {pending_key!r}")
    return out


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read())


def get_intrinsics(config: dict) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) from Camera.* keys (config_reader.hpp:13-17)."""
    return (
        float(config["Camera.fx"]),
        float(config["Camera.fy"]),
        float(config["Camera.cx"]),
        float(config["Camera.cy"]),
    )


def get_depth_factor(config: dict) -> float:
    """depthmap_factor (config_reader.hpp:19-22)."""
    return float(config["depthmap_factor"])


def get_extrinsics(config: dict) -> np.ndarray:
    """4x4 cam_T_posecam from the row-major 'Extrinsics' list
    (config_reader.hpp:24-30); identity when absent (offline.cc:40-43)."""
    ext = config.get("Extrinsics")
    if ext is None:
        return np.eye(4, dtype=np.float32)
    return np.asarray(ext, np.float32).reshape(4, 4)


def get_image_size(config: dict) -> tuple[int, int]:
    """(height, width) from Camera.rows / Camera.cols."""
    return int(config["Camera.rows"]), int(config["Camera.cols"])
