"""Device-time tables of the port's profiler traces (counterpart of
``aonerf.utils.xplane``).

``Trainer.fit`` with ``profile_steps`` > 0 writes a ``torch.profiler``
Chrome trace (``trace_<first step>.json``) under ``run_dir/profile``.
``device_op_table`` reads the newest one and lists its operations by total
time, with their share and count, in ``xplane.device_op_table``'s columns:
the card's kernels, memcpys and memsets where the trace has any, else (a
CPU run) the CPU operations, whose times nest (an operation's time holds
those it calls), so their shares overlap.
"""

import glob
import json
import os
from typing import Dict, Optional, Tuple

# Chrome-trace categories of work on the card, and of operations on the host
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op",)


def latest_trace(trace_dir: str) -> Optional[str]:
    """The newest ``*.json`` trace under ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def op_times(path: str, categories: Tuple[str, ...]) -> Dict[str, Tuple[float, int]]:
    """name -> (total microseconds, count) of the trace's complete events of
    ``categories``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in categories:
            us, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (us + float(e.get("dur", 0.0)), n + 1)
    return out


def timed_ops(path: str) -> Tuple[str, Dict[str, Tuple[float, int]]]:
    """(what they are, ``op_times``): the trace's device operations, or the
    host's where it has none."""
    times = op_times(path, DEVICE_CATEGORIES)
    if times:
        return "device", times
    return "host (cpu_op)", op_times(path, HOST_CATEGORIES)


def device_op_table(trace_dir: str, top_k: int = 30) -> str:
    """Human-readable per-op time table for the newest trace under
    ``trace_dir``: a header with the total, then one line per operation by
    total time: ms, share of the total, count and name."""
    path = latest_trace(trace_dir)
    if path is None:
        return f"(no trace under {trace_dir})"
    what, times = timed_ops(path)
    total_us = sum(us for us, _ in times.values())
    out = [f"== {what}: {total_us / 1e3:.3f} ms total time ({os.path.basename(path)})"]
    for name, (us, cnt) in sorted(times.items(), key=lambda kv: kv[1][0], reverse=True)[:top_k]:
        out.append(f"{us / 1e3:10.3f} ms {100 * us / max(total_us, 1e-30):5.1f}% x{cnt:<6} {name[:100]}")
    return "\n".join(out)
