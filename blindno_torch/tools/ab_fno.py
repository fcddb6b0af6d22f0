"""Time variants of the FNO-layer kernels, or of their wrappers, against each other in
one process on one card.

Run from the repository root::

    python3 -m blindno_torch.tools.ab_fno [--dim 1|2] [--csrc DIR] [--rounds N] \\
        --variant base --variant nopdl \\
        --sub nopdl 'programmaticStreamSerializationAllowed = 1' \\
                    'programmaticStreamSerializationAllowed = 0' \\
        --variant old --source old blindno_torch/_build/old/blindno_torch/csrc \\
        [--probe NAME ...] [--design]
    python3 -m blindno_torch.tools.ab_fno --dim 2 --tiled --variant new --variant old \
        --source old blindno_torch/_build/old/blindno_torch/csrc
    python3 -m blindno_torch.tools.ab_fno --dim 1 --host OLD_SPECTRAL_CUDA_PY

Each variant is the kernel sources of ``--csrc`` (default ``blindno_torch/csrc``), or of
its own ``--source NAME DIR`` (for instance an older commit's sources, unpacked with
``git archive`` into the gitignored build tree), with its ``--sub NAME OLD NEW`` text
substitutions applied (each OLD must occur); a variant without substitutions is the
sources as they are. Every variant is copied into ``blindno_torch/_build/ab/<name>/``
and built there by ``_build.build``, all at once. A variant also named by ``--probe``
computes something else on purpose (a stage switched off, to time the rest) and is
timed without the check against the plain version. ``--design`` (with ``--dim 1``)
adds, after the variants named, one variant per design element of
``csrc/fno1d_layer.cu`` and its stage probes: ``DESIGN_1D`` and ``PROBES_1D`` below,
which are tied to that source's text (a variant whose OLD text is gone raises).

The cases: with ``--dim 2`` (the default), ``chip_smoke.py``'s ``MAIN_SHAPE``,
``NIOFNO2D_INNER`` and ``FIT_SHAPE``, for the layer with gelu and the spectral conv
alone; with ``--tiled``, its ``TILED_SHAPES`` (the 2-D kernel's tiled layouts) and then
the models' shapes (``MODEL_SHAPES_2D``), for the layer with gelu, without it, and the
spectral conv, where each row also carries the plain version's and the ``torch.fft``
restatement's times from one variant's round and the layer's bound
(``chip_smoke.layer_bound``); with ``--dim 1``, its ``HEADS_1D``, ``BRANCH_1D`` and
``GPE_HEADS_1D``, for the layer with gelu and the spectral conv. At each case every
variant's output is held against the plain version (``chip_smoke``'s tolerance of that
dimension, also after replay from a CUDA graph) and its device time is taken by
CUDA-graph replay, ``chip_smoke.graph_ms``, in ``--rounds`` rounds that run the variants
in turn, the order reversed every other round, so that a drift of the card or the host
reaches every variant alike. Prints one JSON line per (variant, case) with every round's
time, their median, least and largest, the number of rounds in which the variant was
slower than the first variant, each kernel's mean device time in a ``torch.profiler``
trace (``chip_smoke.stage_ms``; with programmatic dependent launch on, successive
kernels overlap and these times do not add up), the card's ``nvidia-smi`` line, and last
a summary line of the medians in microseconds, each with its rounds slower.

``--host OLD_SPECTRAL_CUDA_PY`` times the wrappers' host cost instead: another version
of ``blindno_torch/ops/spectral_cuda.py`` is loaded as a module of its own and calls the
same kernel library as this tree's wrapper, so only the Python side differs. At each
case's layer with gelu (its pointwise kernel transposed, as ``FNO1d`` and ``FNO2d``
pass it), the two wrappers and one ``torch.add`` on the same input are called
``--calls`` times in a row under ``torch.inference_mode``, timed on the host clock, in
``--rounds`` alternating rounds. The device keeps up with the 1-D calls, so there the
figure is the host's cost of one call. Prints one JSON line per case with every round's
microseconds per call, their medians and the rounds in which this tree's wrapper was
slower. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from blindno_torch.ops import _build, spectral_cuda
from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d

_RETURN = "  if (a.B >= 0) return;\n"  # a probe's early return (B is never negative)
# Each design element of csrc/fno1d_layer.cu (its source note) as the variant without
# it: (name, [(OLD, NEW), ...]) substitutions on that source's text.
DESIGN_1D = [
    ("nopdl", [("programmaticStreamSerializationAllowed = 1",
                "programmaticStreamSerializationAllowed = 0")]),
    ("l2weights", [("for (int stage_w = 1;", "for (int stage_w = 0;")]),
    ("table", [("  tile = true;\n", "  tile = false;\n"),
               ("L = layout(rows, chunks, cs, N, true,", "L = layout(rows, chunks, cs, N, false,"),
               ("return tile ? 4 : 1;", "return 4;")]),
    ("evenstride", [("* kFwdGroup) | 1;", "* kFwdGroup);")]),
    ("oneout", [("return tile ? 4 : 1;", "return 1;")]),
    ("fwd1", [("L.fm = rows * L.ncm * M > kThreads ? kFwdGroup : 1;", "L.fm = 1;")]),
    ("fwd4", [("L.fm = rows * L.ncm * M > kThreads ? kFwdGroup : 1;", "L.fm = kFwdGroup;")]),
    ("novec", [("const int vec_x = aligned_x && N % 4 == 0;", "const int vec_x = 0;")]),
    ("nofastdiv", [("struct FastDiv {\n  unsigned m, l;\n};",
                    "struct FastDiv {\n  unsigned m, l, d;\n};"),
                   ("/ d + 1), l};", "/ d + 1), l, d};"),
                   ("return int((__umulhi(unsigned(n), f.m) + unsigned(n)) >> f.l);",
                    "return n / int(f.d);")]),
    ("nocluster", [("? chunks : 1;", "? 1 : 1;")]),
    ("clusterall", [("? chunks : 1;", "? chunks : chunks;")]),
    ("rows4", [(">= sms) rows *= 2;", ">= 2 * sms) rows *= 2;")]),
    # not an element: the weights staged before griddepcontrol.wait, which is wrong where
    # the kernel before writes them, to show what reading them after it costs
    ("wearly", [("  blindno::launch_dependents();\n  stage_weights();\n",
                 "  blindno::launch_dependents();\n"),
                ("  __syncthreads();  // the table\n",
                 "  stage_weights();\n  __syncthreads();  // the table\n")]),
]
# The models' 2-D shapes, whose layouts and times a change to the tiled layouts must keep.
MODEL_SHAPES_2D = (chip_smoke.MAIN_SHAPE, chip_smoke.FIT_SHAPE, chip_smoke.NCFPE2D_HEADS,
                   chip_smoke.NIOFNO2D_INNER, chip_smoke.NCFPE2D_INNER, chip_smoke.TP_SLICE)
# Variants that return at a stage boundary, to time the stages before it.
PROBES_1D = [
    ("p_start", [("  if (L.cs > 1) cluster_arrive_relaxed();",
                  _RETURN + "  if (L.cs > 1) cluster_arrive_relaxed();")]),
    ("p_wait", [("  blindno::launch_dependents();\n",
                 "  blindno::launch_dependents();\n" + _RETURN)]),
    ("p_fwd", [("  // ---- mix into the block", _RETURN + "  // ---- mix into the block")]),
    ("p_mix", [("  // ---- inverse transform and epilogue, tile by tile",
                _RETURN + "  // ---- inverse transform and epilogue, tile by tile")]),
]


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


def cases(dim, wrappers=spectral_cuda, tiled=False):
    """(label, shape, kernel call, plain call) of each timed case, the kernel called
    through the wrappers of ``wrappers``; the calls take the inputs of
    ``chip_smoke.layer_inputs``."""
    w = wrappers
    if dim == 1:
        layer = (lambda x, wr, wi, pk, pb, dc: w.fno1d_layer_cuda(x, wr, wi, pk, pb, dc),
                 lambda x, wr, wi, pk, pb, dc: fno1d_layer_plain(x, wr, wi, pk, pb, dc))
        spectral = (lambda x, wr, wi, pk, pb, dc: w.spectral_conv1d_cuda(x, wr, wi, dc),
                    lambda x, wr, wi, pk, pb, dc: spectral_conv1d(x, wr, wi, dc))
        shapes = (chip_smoke.HEADS_1D, chip_smoke.BRANCH_1D, chip_smoke.GPE_HEADS_1D)
        names, calls = ("fno1d_layer gelu", "spectral_conv1d"), (layer, spectral)
    else:
        layer = (lambda x, wr, wi, pk, pb: w.fno2d_layer_cuda(x, wr, wi, pk, pb, True),
                 lambda x, wr, wi, pk, pb: fno2d_layer_plain(x, wr, wi, pk, pb, True))
        linear = (lambda x, wr, wi, pk, pb: w.fno2d_layer_cuda(x, wr, wi, pk, pb, False),
                  lambda x, wr, wi, pk, pb: fno2d_layer_plain(x, wr, wi, pk, pb, False))
        spectral = (lambda x, wr, wi, pk, pb: w.spectral_conv2d_cuda(x, wr, wi),
                    lambda x, wr, wi, pk, pb: spectral_conv2d(x, wr, wi))
        if tiled:  # the tiled layouts' shapes, then the models' shapes that guard their times
            shapes = (*chip_smoke.TILED_SHAPES, *MODEL_SHAPES_2D)
            names, calls = (("fno2d_layer gelu", "fno2d_layer none", "spectral_conv2d"),
                            (layer, linear, spectral))
        else:
            shapes = (chip_smoke.MAIN_SHAPE, chip_smoke.NIOFNO2D_INNER, chip_smoke.FIT_SHAPE)
            names, calls = ("fno2d_layer gelu", "spectral_conv2d"), (layer, spectral)
    return [(name, shape, *call) for shape in shapes for name, call in zip(names, calls)]


def alternating(rounds, names):
    """The order of ``names`` in each round, reversed every other round."""
    return [list(names) if r % 2 == 0 else list(names)[::-1] for r in range(rounds)]


def host_us(fn, calls):
    """Host microseconds per call of ``fn`` over ``calls`` calls, after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def host_ab(args, smi):
    spec = importlib.util.spec_from_file_location("other_spectral_cuda", args.host)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    mine = cases(args.dim)
    theirs = cases(args.dim, other)
    with torch.inference_mode():
        for (name, shape, kernel, _), (_, _, old_kernel, _) in zip(mine, theirs):
            if "gelu" not in name:
                continue
            xs = list(chip_smoke.layer_inputs(shape, "cuda"))
            xs[3] = xs[3].t().contiguous().t()  # pk as the modules pass it
            fns = {"new": lambda: kernel(*xs), "old": lambda: old_kernel(*xs),
                   "torch_add": lambda: torch.add(xs[0], 1.0)}
            torch.testing.assert_close(fns["new"](), fns["old"](), rtol=0, atol=0)
            us = {k: [] for k in fns}
            for order in alternating(args.rounds, fns):
                for k in order:
                    us[k].append(host_us(fns[k], args.calls))
            print(json.dumps({
                "kernel": name, "shape": shape, "us_per_call": us,
                "median_us": {k: statistics.median(v) for k, v in us.items()},
                "rounds_new_slower": sum(a > b for a, b in zip(us["new"], us["old"])),
                "nvidia_smi": smi}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, choices=(1, 2), default=2)
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--source", nargs=2, action="append", default=[],
                    metavar=("VARIANT", "DIR"))
    ap.add_argument("--sub", nargs=3, action="append", default=[],
                    metavar=("VARIANT", "OLD", "NEW"))
    ap.add_argument("--probe", action="append", default=[], metavar="VARIANT")
    ap.add_argument("--design", action="store_true")
    ap.add_argument("--tiled", action="store_true")
    ap.add_argument("--host", type=Path, metavar="OLD_SPECTRAL_CUDA_PY")
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_fno: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if args.host:
        return host_ab(args, smi)
    subs = [tuple(s) for s in args.sub]
    if args.design:
        if args.dim != 1:
            raise SystemExit("ab_fno: --design is the 1-D kernel's")
        for name, pairs in DESIGN_1D + PROBES_1D:
            args.variant.append(name)
            subs += [(name, old, new) for old, new in pairs]
        args.probe += [name for name, _ in PROBES_1D]
    if not args.variant:
        raise SystemExit("ab_fno: name a --variant, or ask for --design or --host")
    tol = chip_smoke.KERNEL_TOL_1D if args.dim == 1 else chip_smoke.KERNEL_TOL

    sources = {v: Path(d) for v, d in args.source}
    dirs = {v: variant_sources(sources.get(v, args.csrc), v,
                               [(o, n) for w, o, n in subs if w == v])
            for v in args.variant}
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = dict(zip(dirs, pool.map(lambda d: _build.load(_build.build(d)), dirs.values())))

    if args.tiled and args.dim != 2:
        raise SystemExit("ab_fno: --tiled is the 2-D kernel's")
    todo = cases(args.dim, tiled=args.tiled)
    times = {(v, i): [] for v in libs for i in range(len(todo))}
    errs, stages, yardsticks = {}, {}, {}
    library = chip_smoke.fft_restatements()
    with torch.inference_mode():
        inputs = [chip_smoke.layer_inputs(shape, "cuda") for _, shape, _, _ in todo]
        for r, order in enumerate(alternating(args.rounds + 1, libs)):
            for v in order:  # the last round takes the profiles
                _build.library = lambda lib=libs[v]: lib
                for i, ((_, shape, kernel, plain), xs) in enumerate(zip(todo, inputs)):
                    fn = lambda: kernel(*xs)
                    if r == args.rounds:
                        stages[v, i] = chip_smoke.stage_ms(fn)
                        continue
                    ms, out = chip_smoke.graph_ms(fn, result=True)
                    if r == 0 and v in args.probe:
                        errs[v, i] = None
                    elif r == 0:
                        want = plain(*xs)
                        errs[v, i] = max(
                            chip_smoke.check_close(f"{v} {shape}", fn(), want, tol),
                            chip_smoke.check_close(f"{v} {shape} replayed", out, want, tol))
                    if r == 0 and args.tiled and i not in yardsticks:
                        name = todo[i][0]
                        act = {"gelu": True, "none": False}.get(name.split()[-1])
                        lib = library[name.split()[0]]
                        yardsticks[i] = dict(
                            plain_ms=chip_smoke.graph_ms(lambda: plain(*xs)),
                            library_ms=chip_smoke.graph_ms(lambda: lib(*xs, act)),
                            **chip_smoke.layer_bound(shape, act is not None))
                    times[v, i].append(ms)
    summary, first = {}, args.variant[0]
    for (v, i), ts in times.items():
        name, shape = todo[i][:2]
        slower = sum(t > t0 for t, t0 in zip(ts, times[first, i]))
        row = dict(variant=v, kernel=name, shape=shape, ms=ts, median_ms=statistics.median(ts),
                   min_ms=min(ts), max_ms=max(ts), rounds_slower_than_first=slower,
                   max_abs_err=errs[v, i], stages_ms=stages[v, i], **yardsticks.get(i, {}),
                   nvidia_smi=smi)
        print(json.dumps(row), flush=True)
        summary.setdefault(f"{name} {shape}", {})[v] = [round(1e3 * row["median_ms"], 3),
                                                         slower]
    print(json.dumps({"median_us_and_rounds_slower": summary, "rounds": args.rounds,
                      "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
