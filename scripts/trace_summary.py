#!/usr/bin/env python
"""Summarize a jax.profiler trace: device busy/idle share, time per
compiled program, and device time per JAX name scope and per op.

Usage:
  python chip_smoke.py --profile /tmp/prof         # or any traced run
  python scripts/trace_summary.py /tmp/prof/online [--top N]

Reads the newest *.xplane.pb under the directory with
jax.profiler.ProfileData (nothing else needed).  Device planes are the
GPU's ("/device:GPU:N"); on the CPU backend the XLA thread-pool lines of
"/host:CPU" stand in.  Ops are attributed to the name scopes the code
sets (jax.named_scope: allocate, visible, fuse/sample, payload_gather,
payload_scatter, carve, seg, splat_zbuffer, ...) through the op_name
metadata of the optimized HLO: pass the *.hlo.txt files chip_smoke.py
writes next to the trace (found automatically in the trace directory).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from collections import defaultdict

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]+)\""
)
_MODULE = re.compile(r"^HloModule\s+([\w.\-]+)")
# derived lines of a GPU device plane that re-state the kernel events
_DERIVED = ("XLA Modules", "XLA Ops", "Steps", "Source code", "Framework")


def find_xplane(root: str) -> str:
    paths = glob.glob(os.path.join(root, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {root}")
    return max(paths, key=os.path.getmtime)


def scope_map(hlo_paths) -> dict:
    """(module, instruction) -> op_name from optimized HLO text dumps."""
    out = {}
    for path in hlo_paths:
        module = None
        with open(path) as f:
            for line in f:
                m = _MODULE.match(line)
                if m:
                    module = m.group(1)
                    continue
                m = _INSTR.match(line)
                if m:
                    out[(module, m.group(1))] = m.group(2)
    return out


def scope_of(op_name: str) -> str:
    """'jit(_step)/jit(main)/fuse/payload_scatter/scatter' -> the name
    scopes only: 'fuse/payload_scatter'."""
    parts = [p for p in op_name.split("/") if not p.startswith(("jit(", "pjit("))]
    return "/".join(parts[:-1]) or "(top level)"


def _stats(ev) -> dict:
    try:
        return dict(ev.stats)
    except (TypeError, ValueError):
        return {}


def op_events(pd):
    """(plane name, [(start_ns, dur_ns, module, op, op_name)]) for every
    device plane: kernel events on GPU streams, XLA ops on CPU threads."""
    planes = []
    for plane in pd.planes:
        is_gpu = plane.name.startswith("/device:")
        if not (is_gpu or plane.name == "/host:CPU"):
            continue
        evs = []
        for line in plane.lines:
            if is_gpu and line.name in _DERIVED:
                continue
            if not is_gpu and not line.name.startswith("tf_XLA"):
                continue
            for ev in line.events:
                st = _stats(ev)
                op = st.get("hlo_op")
                if op is None:
                    continue
                # GPU kernel events carry tf_op "XlaModule:" (no scope);
                # the optimized HLO's op_name metadata fills it in below
                op_name = st.get("tf_op") or st.get("name_scope") or ""
                evs.append((
                    ev.start_ns, ev.duration_ns, st.get("hlo_module", "?"),
                    op, op_name if "/" in op_name else "",
                ))
        if evs:
            planes.append((plane.name, evs))
    return planes


def busy_ns(evs) -> float:
    """Length of the union of the event intervals."""
    total, end = 0.0, None
    for s, d in sorted((e[0], e[1]) for e in evs):
        if end is None or s > end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def summarize(root: str, top: int = 25, hlo_paths=None) -> dict:
    import jax

    path = find_xplane(root)
    if hlo_paths is None:
        hlo_paths = glob.glob(os.path.join(root, "*.hlo.txt"))
    names = scope_map(hlo_paths)
    pd = jax.profiler.ProfileData.from_file(path)
    print(f"# {path}")
    result = {}
    for plane, evs in op_events(pd):
        start = min(e[0] for e in evs)
        stop = max(e[0] + e[1] for e in evs)
        window = stop - start
        busy = busy_ns(evs)
        print(f"## {plane}: window {window / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms, "
              f"idle share {1 - busy / max(window, 1):.4f}")
        by_module = defaultdict(float)
        by_scope = defaultdict(float)
        by_op = defaultdict(lambda: [0.0, 0, ""])
        for _s, d, module, op, op_name in evs:
            op_name = op_name or names.get((module, op), "")
            by_module[module] += d
            by_scope[(module, scope_of(op_name) if op_name else "(unmapped)")] += d
            rec = by_op[(module, op)]
            rec[0] += d
            rec[1] += 1
            rec[2] = op_name
        kernel_total = sum(by_module.values())
        print("### programs")
        for m, d in sorted(by_module.items(), key=lambda kv: -kv[1]):
            print(f"  {d / 1e6:10.3f} ms  {d / kernel_total:6.1%}  {m}")
        print("### name scopes")
        for (m, sc), d in sorted(by_scope.items(), key=lambda kv: -kv[1])[:top]:
            print(f"  {d / 1e6:10.3f} ms  {d / kernel_total:6.1%}  {m}: {sc}")
        print(f"### top {top} ops")
        for (m, op), (d, n, op_name) in sorted(
            by_op.items(), key=lambda kv: -kv[1][0]
        )[:top]:
            print(f"  {d / 1e6:10.3f} ms  {d / kernel_total:6.1%}  x{n:<4d} "
                  f"{m}:{op}  {op_name}")
        result[plane] = {
            "window_ns": window, "busy_ns": busy,
            "scopes": dict(by_scope), "modules": dict(by_module),
        }
    if not result:
        print("no device events found; planes were:")
        for p in pd.planes:
            print(f"  {p.name}: {[ln.name for ln in p.lines][:8]}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--hlo", nargs="*", help="optimized HLO text dumps")
    args = ap.parse_args(argv)
    summarize(args.trace_dir, args.top, args.hlo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
