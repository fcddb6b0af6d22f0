"""Time variants of the FNO2d-layer kernel against each other in one process on one card.

Run from the repository root::

    python3 -m blindno_torch.tools.ab_fno2d [--csrc DIR] [--rounds N] \\
        --variant base --variant nopdl \\
        --sub nopdl 'programmaticStreamSerializationAllowed = 1' \\
                    'programmaticStreamSerializationAllowed = 0'

Each variant is the kernel sources of ``--csrc`` (default ``blindno_torch/csrc``) with
its ``--sub NAME OLD NEW`` text substitutions applied (each OLD must occur); a variant
without substitutions is the sources as they are. Every variant is copied into
``blindno_torch/_build/ab/<name>/`` and built there by ``_build.build``, all at once.
Then, at ``chip_smoke.py``'s ``MAIN_SHAPE`` and ``NIOFNO2D_INNER`` shapes, for the layer
with gelu and for the spectral conv alone, each variant's output is held against the
plain version (``KERNEL_TOL``, also after replay from a CUDA graph) and its device time
is taken by CUDA-graph replay, ``chip_smoke.graph_ms``, in ``--rounds`` rounds that run
the variants in turn, the order reversed every other round, so that a drift of the card
or the host reaches every variant alike. Prints one JSON line per (variant, case) with
every round's time, their median, least and largest, the number of rounds in which the
variant was slower than the first variant, each kernel's mean device time in
a ``torch.profiler`` trace (``chip_smoke.stage_ms``; with programmatic dependent launch
on, the stages overlap and these times do not add up), the card's ``nvidia-smi`` line,
and last a summary line of the medians. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from blindno_torch.ops import _build, spectral_cuda
from blindno_torch.ops.fno_layer import fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv2d


def variant_sources(csrc: Path, name: str, subs) -> Path:
    """Copy ``csrc`` into the build tree under ``name`` with ``subs`` applied."""
    out = _build.PKG / "_build" / "ab" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    for old, new in subs:
        hits = [p for p in out.iterdir() if p.suffix in (".cu", ".cuh") and old in p.read_text()]
        if not hits:
            raise ValueError(f"variant {name}: {old!r} is in no source of {csrc}")
        for p in hits:
            p.write_text(p.read_text().replace(old, new))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--sub", nargs=3, action="append", default=[],
                    metavar=("VARIANT", "OLD", "NEW"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_fno2d: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    dirs = {v: variant_sources(args.csrc, v, [(o, n) for w, o, n in args.sub if w == v])
            for v in args.variant}
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = dict(zip(dirs, pool.map(lambda d: _build.load(_build.build(d)), dirs.values())))

    cases = [(shape, act) for shape in (chip_smoke.MAIN_SHAPE, chip_smoke.NIOFNO2D_INNER)
             for act in (True, None)]
    times = {(v, i): [] for v in libs for i in range(len(cases))}
    errs, stages = {}, {}
    with torch.inference_mode():
        inputs = [chip_smoke.layer_inputs(shape, "cuda") for shape, _ in cases]
        for r in range(args.rounds + 1):  # the last round takes the profiles
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for v in order:
                _build.library = lambda lib=libs[v]: lib
                for i, ((shape, act), (x, wr, wi, pk, pb)) in enumerate(zip(cases, inputs)):
                    if act:
                        fn = lambda: spectral_cuda.fno2d_layer_cuda(x, wr, wi, pk, pb, True)
                        plain = lambda: fno2d_layer_plain(x, wr, wi, pk, pb, True)
                    else:
                        fn = lambda: spectral_cuda.spectral_conv2d_cuda(x, wr, wi)
                        plain = lambda: spectral_conv2d(x, wr, wi)
                    if r == args.rounds:
                        stages[v, i] = chip_smoke.stage_ms(fn)
                        continue
                    ms, out = chip_smoke.graph_ms(fn, result=True)
                    if r == 0:
                        want = plain()
                        errs[v, i] = max(
                            chip_smoke.check_close(f"{v} {shape} act={act}", fn(), want,
                                                   chip_smoke.KERNEL_TOL),
                            chip_smoke.check_close(f"{v} {shape} act={act} replayed", out,
                                                   want, chip_smoke.KERNEL_TOL))
                    times[v, i].append(ms)
    summary, first = {}, args.variant[0]
    for (v, i), ts in times.items():
        shape, act = cases[i]
        kernel = "fno2d_layer gelu" if act else "spectral_conv2d"
        slower = sum(t > t0 for t, t0 in zip(ts, times[first, i]))
        row = dict(variant=v, kernel=kernel, shape=shape, ms=ts, median_ms=statistics.median(ts),
                   min_ms=min(ts), max_ms=max(ts), rounds_slower_than_first=slower,
                   max_abs_err=errs[v, i], stages_ms=stages[v, i], nvidia_smi=smi)
        print(json.dumps(row), flush=True)
        summary.setdefault(f"{kernel} {shape}", {})[v] = row["median_ms"]
    print(json.dumps({"medians_ms": summary, "rounds": args.rounds, "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
