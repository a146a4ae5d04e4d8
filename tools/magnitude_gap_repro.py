"""Run the line tests' magnitude check many times, side by side, recording
each run, to look for the gradient-magnitude gap.

Once, in one of several pytest processes run side by side,
``tests/test_torch_port_lines.py::test_lsd_segments_match_jax[0]`` saw
1,079 of 4,096 gradient magnitudes off by up to 1e-4 while the gradients
agreed within 1e-6. This script repeats that check and records, for every
run, which package moved: it unpacks the committed tree (``git archive
HEAD``) into ``--work``, adds a recorder to its copy of the test, and makes
``--copies`` copies of the file so that as many pytest processes run it at
once (``-n``, ``--dist loadfile``, the tier-1 command's flags), beside
``tests/test_torch_port_registry.py``; then it runs that ``--iters`` times.
The recorder writes one JSON line per run: each package's magnitude against
the f64 root of that package's own f32 gradients (largest difference,
entries over 1e-6), torch's f32 ``torch.sqrt`` likewise, the gradients'
largest difference, the process's flush-to-zero and denormals-are-zero
state (a denormal product and a denormal operand, in numpy and in torch)
and torch's thread counts. The summary is the last line printed.

    python tools/magnitude_gap_repro.py --work DIR [--iters 20] [--copies 4]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = "tests/test_torch_port_lines.py"

RECORDER = '''

def _float_modes():
    """(FTZ, DAZ) of this thread, read off numpy's and torch's arithmetic:
    a product that should be denormal, and a denormal times one."""
    tiny = np.float32(1e-38)
    den = np.float32(1e-40)
    t_tiny, t_den = torch.tensor([1e-38]), torch.tensor([1e-40])
    return dict(ftz_numpy=bool(tiny * np.float32(0.01) == 0), daz_numpy=bool(den * np.float32(1) == 0),
                ftz_torch=bool((t_tiny * 0.01)[0] == 0), daz_torch=bool((t_den * 1.0)[0] == 0))


def _record_magnitude(seed, gx, gy, tgx, tgy, jmag, tmag):
    import json, os, time
    jx, jy, px, py = np.asarray(gx), np.asarray(gy), _n(tgx), _n(tgy)
    jref = np.sqrt((jx * jx + jy * jy).astype(np.float64)).astype(np.float32)
    pref = np.sqrt((px * px + py * py).astype(np.float64)).astype(np.float32)
    jm, tm, t32 = np.asarray(jmag), _n(tmag), _n(torch.sqrt(tgx * tgx + tgy * tgy))
    row = dict(t=time.time(), pid=os.getpid(), worker=os.environ.get("PYTEST_XDIST_WORKER"),
               seed=seed, torch_threads=torch.get_num_threads(),
               torch_interop=torch.get_num_interop_threads(), **_float_modes(),
               jax_err=float(np.abs(jm - jref).max()), jax_n=int((np.abs(jm - jref) > 1e-6).sum()),
               port_err=float(np.abs(tm - pref).max()), port_n=int((np.abs(tm - pref) > 1e-6).sum()),
               torch32_err=float(np.abs(t32 - pref).max()),
               torch32_n=int((np.abs(t32 - pref) > 1e-6).sum()),
               cross=float(np.abs(tm - jm).max()), cross_n=int((np.abs(tm - jm) > 1e-6).sum()),
               grad_err=float(max(np.abs(px - jx).max(), np.abs(py - jy).max())))
    with open(os.path.join(os.environ["MAGNITUDE_LOG"], f"{os.getpid()}.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\\n")
'''
ANCHOR = "# ------------------------------------------------------------ lines\n"
CALL_AFTER = "    tfields = (tlines.gradient_magnitude(tgx, tgy), torch.atan2(tgy, tgx))\n"
CALL = "    _record_magnitude(seed, gx, gy, tgx, tgy, jfields[0], tfields[0])\n"


def prepare(work: str, copies: int) -> list:
    """The committed tree in ``work`` with the recorder in ``copies`` copies
    of the test file; returns the test files to run."""
    os.makedirs(work, exist_ok=True)
    archive = subprocess.run(["git", "archive", "HEAD"], cwd=ROOT, check=True,
                             capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", work], input=archive, check=True)
    src = open(os.path.join(work, TEST)).read()
    if ANCHOR not in src or CALL_AFTER not in src:
        raise SystemExit(f"{TEST} no longer has the lines this script patches")
    src = src.replace(ANCHOR, RECORDER + "\n" + ANCHOR).replace(CALL_AFTER, CALL_AFTER + CALL)
    files = []
    for i in range(copies):
        name = TEST if i == 0 else TEST.replace(".py", f"_copy{i}.py")
        with open(os.path.join(work, name), "w") as f:
            f.write(src)
        files.append(name)
    return files + ["tests/test_torch_port_registry.py"]


def summarize(log_dir: str) -> dict:
    rows = [json.loads(line) for path in glob.glob(os.path.join(log_dir, "*.jsonl"))
            for line in open(path)]
    if not rows:
        return {"runs": 0}
    out = {"runs": len(rows), "processes": len({r["pid"] for r in rows})}
    for k in ("jax_err", "port_err", "torch32_err", "cross", "grad_err"):
        out[f"max_{k}"] = max(r[k] for r in rows)
    for k in ("jax_n", "port_n", "torch32_n", "cross_n"):
        out[f"runs_with_{k}"] = sum(r[k] > 0 for r in rows)
    modes = collections.Counter(
        f"ftz {r['ftz_numpy']}/{r['ftz_torch']} daz {r['daz_numpy']}/{r['daz_torch']}" for r in rows)
    out["float_modes (numpy/torch)"] = dict(modes)
    out["torch_threads"] = dict(collections.Counter(str(r["torch_threads"]) for r in rows))
    out["gaps"] = [r for r in rows if r["cross_n"] or r["jax_n"] or r["port_n"]][:10]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True, help="a directory outside the repository")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--copies", type=int, default=4)
    args = ap.parse_args(argv)
    files = prepare(args.work, args.copies)
    log_dir = os.path.join(args.work, "magnitude_log")
    os.makedirs(log_dir, exist_ok=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "MAGNITUDE_LOG": log_dir}
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow", "-p", "no:cacheprovider",
           "-p", "xdist", "-n", str(len(files)), "--dist", "loadfile", "-p", "no:randomly",
           "-k", "lsd_segments or marching or deeplsd or registry"]
    for i in range(args.iters):
        proc = subprocess.run(cmd, cwd=args.work, env=env, capture_output=True, text=True,
                              timeout=1800)
        tail = proc.stdout.strip().splitlines()[-1:] or [""]
        print(json.dumps({"iter": i, "rc": proc.returncode, "pytest": tail[0],
                          "runs_so_far": summarize(log_dir)["runs"]}), flush=True)
    print(json.dumps(summarize(log_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
