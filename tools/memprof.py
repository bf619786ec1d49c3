#!/usr/bin/env python
"""Peak-RSS attribution for a command tree: samples /proc/<pid>/smaps of
the command and every descendant at an interval, and reports, per process,
the peak total RSS and the category breakdown at that peak:

  anon     private anonymous mappings (numpy arrays outside the slab pool,
           Python heap, native scratch)
  shm      /dev/shm-backed mappings
  bam      file-backed mappings of the profiled BAM (memmap'd source)
  file     every other file-backed mapping (.so text, page-cache windows)

Usage:
    python tools/memprof.py [--interval 0.5] [--tag bam=/path/ds.bam] \
        -- <command...>

Prints one JSON line at exit; also a per-second CSV to --csv if given.
This is a measurement tool for the WGS memory work (README "Memory
engineering"); it has no product dependencies.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _descendants(root_pid: int):
    """root_pid plus all descendant PIDs, via /proc/<pid>/task/*/children."""
    out, todo = [], [root_pid]
    while todo:
        pid = todo.pop()
        out.append(pid)
        try:
            for task in os.listdir("/proc/%d/task" % pid):
                try:
                    with open("/proc/%d/task/%s/children" % (pid, task)) as f:
                        todo.extend(int(c) for c in f.read().split())
                except OSError:
                    pass
        except OSError:
            pass
    return out


def _sample(pid: int, bam: str):
    """(total_kb, {category: kb}) from /proc/pid/smaps, or None if gone."""
    cats = {"anon": 0, "shm": 0, "bam": 0, "file": 0}
    total = 0
    try:
        with open("/proc/%d/smaps" % pid) as f:
            cat = "anon"
            for ln in f:
                parts = ln.split()
                if not parts:
                    continue
                if not parts[0].endswith(":") and "-" in parts[0]:
                    # VMA header line: addr-range perms off dev inode [path]
                    path = parts[5] if len(parts) > 5 else ""
                    if bam and path == bam:
                        cat = "bam"
                    elif path.startswith("/dev/shm"):
                        cat = "shm"
                    elif path.startswith("/") or path.startswith("["):
                        cat = "file" if path.startswith("/") else "anon"
                    else:
                        cat = "anon"
                elif ln.startswith("Rss:"):
                    kb = int(ln.split()[1])
                    cats[cat] += kb
                    total += kb
    except OSError:
        return None
    return total, cats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--tag", default="", help="bam=<path> to split out "
                    "that file's mappings as their own category")
    ap.add_argument("--csv", default="")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    bam = ""
    if args.tag.startswith("bam="):
        bam = os.path.realpath(args.tag[4:])

    t0 = time.time()
    proc = subprocess.Popen(cmd)
    peaks = {}        # pid -> dict(peak_kb, at_s, cats, argv)
    csv = open(args.csv, "w") if args.csv else None
    if csv:
        csv.write("t_s,pid,total_kb,anon_kb,shm_kb,bam_kb,file_kb\n")
    while proc.poll() is None:
        now = time.time() - t0
        for pid in _descendants(proc.pid):
            s = _sample(pid, bam)
            if s is None:
                continue
            total, cats = s
            if csv:
                csv.write("%.1f,%d,%d,%d,%d,%d,%d\n"
                          % (now, pid, total, cats["anon"], cats["shm"],
                             cats["bam"], cats["file"]))
            rec = peaks.get(pid)
            if rec is None or total > rec["peak_kb"]:
                argv = ""
                try:
                    with open("/proc/%d/cmdline" % pid, "rb") as f:
                        argv = f.read().replace(b"\0", b" ").decode()[:160]
                except OSError:
                    pass
                peaks[pid] = dict(peak_kb=total, at_s=round(now, 1),
                                  cats=cats, argv=argv or
                                  (rec["argv"] if rec else ""))
        time.sleep(args.interval)
    rc = proc.returncode
    if csv:
        csv.close()
    worst = sorted(peaks.values(), key=lambda r: -r["peak_kb"])[:6]
    print(json.dumps(dict(
        rc=rc, wall_s=round(time.time() - t0, 1),
        max_proc_peak_gb=round(worst[0]["peak_kb"] / 1048576, 2) if worst
        else 0.0,
        procs=[dict(peak_gb=round(r["peak_kb"] / 1048576, 2),
                    at_s=r["at_s"],
                    anon_gb=round(r["cats"]["anon"] / 1048576, 2),
                    shm_gb=round(r["cats"]["shm"] / 1048576, 2),
                    bam_gb=round(r["cats"]["bam"] / 1048576, 2),
                    file_gb=round(r["cats"]["file"] / 1048576, 2),
                    argv=r["argv"]) for r in worst])))
    sys.exit(rc)


if __name__ == "__main__":
    main()
