"""Merge a host span trace with a ``torch.profiler`` trace into ONE
timeline (the port's copy of the reference's ``tools/trace_merge.py``).

Inputs:

  * HOST — the Chrome trace written by ``MXNET_TPU_TRACE=chrome:<path>``
    (``mxnet_tpu_torch.tracing``'s line-oriented array format; a
    truncated file from a killed job still loads);
  * DEVICE — a ``torch.profiler`` Chrome export (``mx.profiler.dump()``
    or ``profile.export_chrome_trace``; ``.json`` or ``.json.gz``), or a
    directory holding such exports (the newest is used).

Output is a single Chrome trace (load it in ui.perfetto.dev or
chrome://tracing) with the two planes kept apart:

  * host spans keep their thread lanes under pid 1 ("mxnet_tpu_torch
    host");
  * device planes are re-pid'd to 1000 + n.  A device plane is a process
    the reference's heuristic names one (a process_name holding
    "/device:" and the like), or one Kineto gives a GPU lane: a
    ``process_labels`` entry naming a GPU, or the GPU-side event
    categories (``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``gpu_user_annotation``) on the card's stream lanes.  The export's
    host lanes are dropped (the span trace is the host plane — keeping
    both would show every step twice).

The two captures use different clocks (tracing.py stamps epoch-anchored
perf_counter microseconds; Kineto its own), so by default each plane is
shifted so its earliest event sits at t=0.  ``--align none`` keeps raw
timestamps, ``--align epoch`` shifts ONLY the device plane by
(host_min - device_min), leaving host spans on wall-clock time.

Pure stdlib.

Usage:
  python -m mxnet_tpu_torch.trace_merge RUN.trace.json profile.json \\
      -o merged.json
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

HOST_PID = 1
DEVICE_PID_BASE = 1000

#: the event categories of Kineto's GPU stream lanes
GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset",
                  "gpu_user_annotation")


# --------------------------------------------------------------- loading
def load_chrome_trace(path):
    """Lenient Chrome-trace loader: gz or plain, object or bare array, and
    the truncated line-array form a killed job leaves behind."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    try:
        obj = json.loads(text)
    except ValueError:
        # truncated array: parse line by line, tolerating the cut tail
        events = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if isinstance(e, dict):
                events.append(e)
        return events
    if isinstance(obj, dict):
        return obj.get("traceEvents", [])
    if isinstance(obj, list):
        return [e for e in obj if isinstance(e, dict)]
    return []


def resolve_device_trace(path):
    """Accept a trace file or a directory of ``torch.profiler`` exports
    (the newest ``*.json`` / ``*.json.gz`` inside)."""
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "**", "*.json"),
                          recursive=True) + glob.glob(
            os.path.join(path, "**", "*.json.gz"), recursive=True)
        if not files:
            raise FileNotFoundError("no *.json[.gz] trace under %s" % path)
        return max(files, key=os.path.getmtime)
    return path


def device_pids(events):
    """pids of the device planes: the reference's process-name heuristic,
    Kineto's GPU ``process_labels``, and any pid carrying GPU-side event
    categories."""
    pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str(e.get("args", {}).get("name", ""))
            if "/device:" in pname.lower() or pname.startswith("TPU") or \
                    "accelerator" in pname.lower():
                pids.add(e.get("pid"))
        elif e.get("ph") == "M" and e.get("name") == "process_labels":
            if "gpu" in str(e.get("args", {}).get("labels", "")).lower():
                pids.add(e.get("pid"))
        elif e.get("ph") == "X" and e.get("cat") in GPU_CATEGORIES:
            pids.add(e.get("pid"))
    return pids


# --------------------------------------------------------------- merging
def _plane_min_ts(events):
    ts = [e["ts"] for e in events
          if e.get("ph") == "X" and isinstance(e.get("ts"), (int, float))]
    return min(ts) if ts else 0.0


def merge_traces(host_events, dev_events, align="zero"):
    """Return (merged_event_list, stats dict)."""
    dpids = device_pids(dev_events)
    dev_kept = [e for e in dev_events if e.get("pid") in dpids]

    host_shift = 0.0
    dev_shift = 0.0
    if align == "zero":
        host_shift = -_plane_min_ts(host_events)
        dev_shift = -_plane_min_ts(dev_kept)
    elif align == "epoch":
        dev_shift = _plane_min_ts(host_events) - _plane_min_ts(dev_kept)

    merged = [{"ph": "M", "name": "process_name", "pid": HOST_PID,
               "args": {"name": "mxnet_tpu_torch host"}},
              {"ph": "M", "name": "process_sort_index", "pid": HOST_PID,
               "args": {"sort_index": 0}}]
    host_x = 0
    for e in host_events:
        e = dict(e)
        if e.get("ph") == "M" and e.get("name") == "process_name":
            continue  # replaced by the plane header above
        e["pid"] = HOST_PID
        if e.get("ph") == "X":
            e["ts"] = e.get("ts", 0) + host_shift
            host_x += 1
        merged.append(e)

    pid_map = {}
    dev_x = 0
    for e in dev_kept:
        e = dict(e)
        new_pid = pid_map.setdefault(e["pid"],
                                     DEVICE_PID_BASE + len(pid_map))
        e["pid"] = new_pid
        if e.get("ph") == "X":
            e["ts"] = e.get("ts", 0) + dev_shift
            dev_x += 1
        merged.append(e)

    return merged, {"host_events": host_x, "device_events": dev_x,
                    "device_planes": len(pid_map),
                    "host_shift_us": host_shift, "device_shift_us": dev_shift}


def merge_files(host, device, out, align="zero"):
    """Merge the two files into ``out``; returns the stats dict."""
    host_events = load_chrome_trace(host)
    dev_events = load_chrome_trace(resolve_device_trace(device))
    merged, stats = merge_traces(host_events, dev_events, align=align)
    with open(out, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    stats["out"] = out
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Merge an MXNET_TPU_TRACE host trace with a "
                    "torch.profiler trace into one Chrome trace.")
    ap.add_argument("host", help="host span trace (MXNET_TPU_TRACE output)")
    ap.add_argument("device",
                    help="torch.profiler Chrome export (*.json[.gz]) or a "
                         "directory of them")
    ap.add_argument("-o", "--out", default="merged.trace.json",
                    help="output path (default: merged.trace.json)")
    ap.add_argument("--align", choices=("zero", "epoch", "none"),
                    default="zero",
                    help="zero: both planes start at t=0 (default); "
                         "epoch: shift device onto host wall-clock; "
                         "none: raw timestamps")
    args = ap.parse_args(argv)
    stats = merge_files(args.host, args.device, args.out, align=args.align)
    print(json.dumps(stats))
    if stats["device_events"] == 0:
        print("warning: no device-plane events found (a CPU profile "
              "exports host lanes only)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
