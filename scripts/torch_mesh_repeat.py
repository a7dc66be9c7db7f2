#!/usr/bin/env python3
"""Run the mesh card tests again and again, each run its own process with
its whole log kept, and catch a native frame if one of them crashes.

    python3 scripts/torch_mesh_repeat.py --runs 30 [--out DIR]
        [--timeout S] [--budget-s S]

Each run is ``python -X faulthandler -m pytest --noconftest
tests/test_torch_cuda.py -k mesh -v -s`` from the checkout this script
lies in, with ``TORCH_SHOW_CPP_STACKTRACES=1``; its output goes to
``DIR/run_NN.log`` (default
``chiprun_out/mesh_repeat``). Meant for a host with several cards, where
the cases with a card per rank run (the four-card crash in the first
collective of a fresh mesh, seen when the mesh's collectives ran on NCCL
groups, ROADMAP Queue 3).

Before the runs it probes which native tools work on this host, on a
child that dereferences a null pointer: a core file (``RLIMIT_CORE``
raised to its hard limit for the child only; ``core_pattern`` read,
never written), ``gdb -batch``, ``catchsegv``, and
``scripts/segv_backtrace.c`` built with ``cc`` into ``DIR`` and
preloaded (a handler that prints the faulting thread's native frames
after faulthandler's Python stacks). It takes the first that gave a
frame, in that order (else none): with ``core`` a crashed run's core
file is read with ``gdb -batch -ex 'thread apply all bt'``; with
``gdb`` every run runs under ``gdb -batch`` (``thread apply all bt`` at
a fatal signal); with ``catchsegv`` under it; with ``backtrace`` every
run has the handler preloaded (``LD_PRELOAD``). Prints one JSON line for
the probe, one per run (return code, the signal, seconds, pytest's
summary, whether a native frame was caught) and a summary; exits 1 if a
run failed or crashed, or if ``--budget-s`` left runs unrun.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEGFAULT = [sys.executable, "-c", "import ctypes; ctypes.string_at(0)"]
GDB = ["gdb", "-q", "-nx", "-batch",
       "-ex", "set pagination off",
       "-ex", "set print thread-events off",
       "-ex", "handle SIGPIPE SIGUSR1 SIGUSR2 nostop noprint pass",
       "-ex", "run",
       "-ex", "thread apply all bt 40",
       "--args"]
# A frame as gdb prints it, or as glibc's backtrace_symbols_fd does.
FRAME = re.compile(r"^(#\d+\s+0x[0-9a-f]+ in \S+|\S+\(\S*\)\[0x[0-9a-f]+\])$",
                   re.M)
HANDLER = Path(__file__).resolve().parent / "segv_backtrace.c"


def _core_limit():
    """In the child only: core files up to the hard limit (raising the
    hard limit itself needs a privilege the process may not have)."""
    hard = resource.getrlimit(resource.RLIMIT_CORE)[1]
    resource.setrlimit(resource.RLIMIT_CORE, (hard, hard))


def _run(cmd, *, timeout, cwd=None, preexec=None, env=None):
    """(return code or None on a timeout, the output). The child runs in
    a session of its own, killed whole at the limit (a child under gdb
    leaves no inferior behind)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            errors="replace", cwd=cwd, env=env,
                            preexec_fn=preexec, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
        return proc.returncode, text
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        return None, text + f"\n--- killed at the {timeout:.0f} s limit ---"


def _inferior_rc(rc, text: str):
    """Under gdb, the test process's own exit code, read from gdb's
    report (gdb's exit code is its own)."""
    if re.search(r"\[Inferior \d+ \(process \d+\) exited normally\]", text):
        return 0
    m = re.search(r"\[Inferior \d+ \(process \d+\) exited with code "
                  r"(\d+)\]", text)
    if m:
        return int(m.group(1), 8)
    m = re.search(r"received signal (SIG[A-Z]+)", text)
    if m:
        return -getattr(signal, m.group(1))
    return rc


def probe(build_dir: Path) -> dict:
    """Which native tools gave a frame for a child's null dereference."""
    out = {}
    try:
        out["core_pattern"] = Path(
            "/proc/sys/kernel/core_pattern").read_text().strip()
    except OSError as e:
        out["core_pattern"] = f"unreadable: {e}"
    out["core_limit"] = resource.getrlimit(resource.RLIMIT_CORE)
    with tempfile.TemporaryDirectory() as tmp:
        rc, _ = _run(SEGFAULT, timeout=60, cwd=tmp, preexec=_core_limit)
        cores = sorted(p.name for p in Path(tmp).iterdir()
                       if p.name.startswith("core"))
        out["core"] = {"rc": rc, "files": cores}
        if cores and shutil.which("gdb"):
            _, text = _run(["gdb", "-q", "-nx", "-batch", "-ex", "bt",
                            sys.executable, str(Path(tmp) / cores[0])],
                           timeout=120)
            out["core"]["frames"] = len(FRAME.findall(text))
    if shutil.which("gdb"):
        rc, text = _run(GDB + SEGFAULT, timeout=120)
        out["gdb"] = {"rc": rc, "sigsegv": "SIGSEGV" in text,
                      "frames": len(FRAME.findall(text)),
                      "tail": text.strip().splitlines()[-6:]}
    else:
        out["gdb"] = None
    if shutil.which("catchsegv"):
        rc, text = _run(["catchsegv"] + SEGFAULT, timeout=60)
        out["catchsegv"] = {"rc": rc, "backtrace": "Backtrace" in text}
    else:
        out["catchsegv"] = None
    lib = build_dir / "libsegv_backtrace.so"
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc:
        rc, text = _run([cc, "-shared", "-fPIC", "-O1", "-o", str(lib),
                         str(HANDLER)], timeout=120)
        if rc == 0:
            _, text = _run([sys.executable, "-X", "faulthandler"]
                           + SEGFAULT[1:], timeout=60,
                           env=dict(os.environ, LD_PRELOAD=str(lib)))
            out["backtrace"] = {"lib": str(lib),
                                "frames": len(FRAME.findall(text))}
        else:
            out["backtrace"] = {"build_rc": rc, "log": text[-400:]}
    else:
        out["backtrace"] = None
    works = []
    if out["core"]["files"] and out["core"].get("frames"):
        works.append("core")
    if out["gdb"] and out["gdb"]["frames"]:
        works.append("gdb")
    if out["catchsegv"] and out["catchsegv"]["backtrace"]:
        works.append("catchsegv")
    if out["backtrace"] and out["backtrace"].get("frames"):
        works.append("backtrace")
    out["works"] = works
    return out


def _summary(text: str) -> str:
    for line in reversed(text.splitlines()):
        if re.search(r"\d+ (passed|failed|error)", line) and " in " in line:
            return line.strip("= ").strip()
    return ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--out", default="chiprun_out/mesh_repeat")
    ap.add_argument("--timeout", type=float, default=180.0)
    ap.add_argument("--budget-s", type=float, default=None,
                    help="seconds for all the runs: a run starts only if "
                         "twice the slowest run so far still fits")
    args = ap.parse_args()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    found = probe(out)
    native = (found["works"] or ["none"])[0]
    print(json.dumps({"probe": found, "native": native}), flush=True)
    env = dict(os.environ, TORCH_SHOW_CPP_STACKTRACES="1")
    if native == "backtrace":
        env["LD_PRELOAD"] = found["backtrace"]["lib"]
    test = [sys.executable, "-X", "faulthandler", "-m", "pytest",
            "--noconftest", "tests/test_torch_cuda.py", "-k", "mesh",
            "-v", "-s", "-p", "no:cacheprovider"]
    wrap = {"gdb": GDB, "catchsegv": ["catchsegv"]}.get(native, [])
    bad, slowest, ran = [], 0.0, 0
    start = time.perf_counter()
    for i in range(1, args.runs + 1):
        timeout = args.timeout
        if args.budget_s is not None:
            left = args.budget_s - (time.perf_counter() - start)
            if left < 2 * slowest or left < 10:
                break
            timeout = min(timeout, left)
        log = out / f"run_{i:02d}.log"
        t0 = time.perf_counter()
        rc, text = _run(wrap + test, timeout=timeout, cwd=ROOT, env=env,
                        preexec=_core_limit if native == "core" else None)
        secs = time.perf_counter() - t0
        slowest, ran = max(slowest, secs), ran + 1
        if native == "gdb":
            rc = _inferior_rc(rc, text)
        cores = sorted(p for p in ROOT.iterdir()
                       if p.is_file() and p.name.startswith("core"))
        if cores and shutil.which("gdb"):
            _, bt = _run(["gdb", "-q", "-nx", "-batch", "-ex",
                          "thread apply all bt 40", sys.executable,
                          str(cores[0])], timeout=300)
            text += "\n--- core backtrace ---\n" + bt
        for p in cores:
            p.unlink()
        log.write_text(text)
        summary = _summary(text)
        crashed = ("Fatal Python error" in text or "SIGSEGV" in text
                   or (isinstance(rc, int) and rc < 0))
        rec = {"run": i, "rc": rc, "seconds": secs, "summary": summary,
               "crashed": crashed,
               "native_frames": len(FRAME.findall(text)),
               "log": str(log)}
        if isinstance(rc, int) and rc < 0:
            rec["signal"] = signal.Signals(-rc).name
        ok = (rc == 0 and not crashed and summary
              and "failed" not in summary and "error" not in summary)
        if not ok:
            bad.append(i)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"runs": ran, "asked": args.runs, "native": native,
                      "bad": bad,
                      "seconds": time.perf_counter() - start}), flush=True)
    return 1 if bad or ran < args.runs else 0


if __name__ == "__main__":
    sys.exit(main())
