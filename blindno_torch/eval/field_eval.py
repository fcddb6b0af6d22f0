"""Field-space evaluation (counterpart of ``blindno/eval/field_eval.py``): batched
eval-mode prediction, the port's serving entry point; its symmetry test-time average;
and the suite eval, which loads the best checkpoint, predicts the test set's fields,
and writes per-sample metrics and denormalized predictions.

Eval inputs are normalized with the *train-set* statistics, kept in a sidecar npz next
to the train archive (:func:`cached_train_stats`; the JAX package writes the same
file). Every suite's targets are handled, and the suite eval draws the first test
samples' fields against their truth (:func:`_figures`).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np
import torch

from blindno_torch import default_device
from blindno_torch.data.datasets import FieldStats, MaxStats
from blindno_torch.eval.metrics import relative_l2_per_field
from blindno_torch.train.checkpoint import load_best

def _device_of(model, device):
    dev = default_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model lives on {model_dev}, not on {dev}; move it first")
    return model_dev


def _batches(inputs_norm, batch, dev):
    for s in range(0, inputs_norm.shape[0], batch):
        yield torch.as_tensor(np.asarray(inputs_norm[s:s + batch], np.float32)).to(dev)


def predict_fields(model, inputs_norm, grid, batch: int = 16, device=None):
    """inputs_norm (M, L, *spatial) and grid (*spatial, d), numpy -> (M, *spatial, F)
    numpy: the grid is (N, 1) for the 1-D models and (H, W, 2) for the 2-D one.

    Runs on ``device`` (CUDA unless the caller passes another), where the model must
    already live, under ``torch.inference_mode``.
    """
    dev = _device_of(model, device)
    g = torch.as_tensor(np.asarray(grid, np.float32), device=dev)
    with torch.inference_mode():
        return np.concatenate([model(xb, g).cpu().numpy()
                               for xb in _batches(inputs_norm, batch, dev)])


def tta_indices(kind: str):
    """Inverse-element index per group element of ``make_augment(kind)``.

    D4 element i<4 is the rotation r^i (inverse r^{(4-i)%4}); i>=4 is the
    reflection r^k s, an involution (its own inverse). C4: (4-i)%4. flip1d:
    both elements are involutions.
    """
    if kind == "flip1d":
        return [0, 1]
    if kind == "c4_vector":
        return [(4 - i) % 4 for i in range(4)]
    if kind == "d4_scalar":
        return [(4 - i) % 4 if i < 4 else i for i in range(8)]
    raise ValueError(f"unknown augment kind: {kind!r}")


def predict_fields_tta(model, inputs_norm, grid, kind: str, batch: int = 16, device=None):
    """Symmetry test-time ensembling: the mean of T_i^{-1}(model(T_i(x))) over the group
    used for training augmentation (TrainConfig.augment), with :func:`predict_fields`'s
    arguments and device rule. One forward per group element and batch."""
    from blindno_torch.train.loop import make_augment

    fns = make_augment(kind)
    inv = tta_indices(kind)
    dev = _device_of(model, device)
    g = torch.as_tensor(np.asarray(grid, np.float32), device=dev)
    outs = []
    with torch.inference_mode():
        for xb in _batches(inputs_norm, batch, dev):
            # 2 channels: the c4 vector rule indexes components 0 and 1
            dummy_y = xb.new_zeros(xb.shape[:1] + xb.shape[2:] + (2,))
            dummy_x = xb[:, :1]
            canon = []
            for i, f in enumerate(fns):
                xt, _ = f(xb, dummy_y)
                _, out = fns[inv[i]](dummy_x, model(xt.contiguous(), g))
                canon.append(out)
            outs.append(torch.stack(canon).mean(0).cpu().numpy())
    return np.concatenate(outs)


@dataclass
class TrainStats:
    """The two things eval needs from a train archive: normalization statistics and
    the target field count."""

    stats: dict
    n_fields: int


def _load_npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def cached_train_stats(spec, workdir: str) -> TrainStats:
    """Train-set normalization stats from a sidecar npz next to the train archive,
    keyed on the archive's (mtime, size), so regenerating a dataset invalidates it. The
    sidecar is named after the suite, not the archive: gpe1d and gpe1d_vgk share one
    archive and normalize it differently. It is written to a file of this process's own
    and renamed into place, so that another process reading it (an eval beside a
    time-error stage) finds it whole or not at all."""
    src = os.path.join(workdir, "data", spec.train_file)
    sidecar = os.path.join(workdir, "data", f"{spec.name}.stats.npz")
    mtime, size = os.path.getmtime(src), os.path.getsize(src)
    if os.path.exists(sidecar):
        with np.load(sidecar, allow_pickle=False) as z:
            if float(z["src_mtime"]) == mtime and int(z["src_size"]) == size:
                return _stats_from_arrays({k: z[k] for k in z.files})
    train_ds = spec.loader(_load_npz(src))
    ts = TrainStats(train_ds.stats, int(train_ds.targets.shape[-1]))
    part = f"{sidecar}.{os.getpid()}.part"
    try:
        with open(part, "wb") as fh:
            np.savez(fh, **_stats_to_arrays(ts, mtime, size))
        os.replace(part, sidecar)
    finally:
        if os.path.exists(part):  # a write that failed
            os.remove(part)
    return ts


def _stats_to_arrays(ts: TrainStats, mtime: float, size: int) -> dict:
    out = {"src_mtime": np.float64(mtime), "src_size": np.int64(size),
           "n_fields": np.int64(ts.n_fields)}
    for name, s in ts.stats.items():
        if isinstance(s, MaxStats):
            out[f"max__{name}"] = np.array([s.y_max, s.v_max, s.g_max, s.kappa_max])
        else:
            out[f"scale__{name}"] = np.float64(s.scale)
            out[f"mean__{name}"] = s.mean
            out[f"std__{name}"] = s.std
    return out


def _stats_from_arrays(arrs: dict) -> TrainStats:
    stats = {}
    for k, v in arrs.items():
        if k.startswith("max__"):
            stats[k[5:]] = MaxStats(*(float(a) for a in v))
        elif k.startswith("scale__"):
            stats[k[7:]] = FieldStats(float(v), arrs[f"mean__{k[7:]}"], arrs[f"std__{k[7:]}"])
    return TrainStats(stats, int(arrs["n_fields"]))


def _target_kind(stats: dict) -> str:
    """The suite's targets, told by its statistics: ``"max"``, the GPE suites' V (and g
    and kappa for gpe1d_vgk) under :class:`MaxStats`; ``"F"``, the ncfpe2d force (Fx,
    Fy); ``"fpe1d"``, the potential on the grid ((1, N) statistics) and the scalar drag
    ((1, 1)); ``"fpe2d"``, the potential and drag fields ((1, Nx, Ny) statistics)."""
    if "max" in stats:
        return "max"
    if "F" in stats:
        return "F"
    if {"potential", "drag"} <= stats.keys():
        return "fpe1d" if np.ndim(stats["potential"].mean) == 2 else "fpe2d"
    raise ValueError(f"no suite has the statistics {sorted(stats)}")


def normalized_test_inputs(train_ds: TrainStats, test):
    """The test archive's snapshots normalized with the train statistics: divided by the
    snapshots' maximum in the GPE suites, standardized in the FPE suites."""
    if _target_kind(train_ds.stats) == "max":
        return np.asarray(test["y"], np.float32) / train_ds.stats["max"].y_max
    return train_ds.stats["traj"].normalize(np.asarray(test["trajectories"]))


def _normalized_test_targets(spec, train_ds: TrainStats, test):
    """Normalize the raw test targets with train statistics, shaped like model output:
    (M, N, F) in 1-D, (M, Nx, Ny, 2) in 2-D."""
    stats = train_ds.stats
    kind = _target_kind(stats)
    if kind == "max":
        m = stats["max"]
        v = np.asarray(test["V"], np.float32) / m.v_max
        if train_ds.n_fields != 3:  # V alone; gpe1d_vgk adds g and kappa
            return v[..., None]
        nx = v.shape[1]
        g = np.asarray(test["g"], np.float32) / m.g_max
        k = np.asarray(test["kappa"], np.float32) / m.kappa_max
        return np.concatenate([v[..., None], np.repeat(g[:, None, None], nx, 1),
                               np.repeat(k[:, None, None], nx, 1)], axis=2)
    if kind == "F":
        return np.moveaxis(stats["F"].normalize(np.asarray(test["F"])), 1, -1)
    pot = stats["potential"].normalize(np.asarray(test["potential"]))
    if kind == "fpe1d":  # the scalar drag, replicated over the grid
        drag = stats["drag"].normalize(np.asarray(test["drag"]).reshape(-1, 1))
        return np.stack([pot, np.repeat(drag, pot.shape[1], axis=1)], axis=2)
    drag = stats["drag"].normalize(np.asarray(test["drag"]))
    return np.stack([pot, drag], axis=3)


def denormalize_predictions(spec, train_ds: TrainStats, preds_norm):
    """Model-output space -> physical units, channel-last as the model's output. In
    fpe1d the drag is a scalar: the mean of the drag channel over the grid, replicated."""
    stats = train_ds.stats
    kind = _target_kind(stats)
    if kind == "max":
        m = stats["max"]
        out = preds_norm.copy()
        out[..., 0] *= m.v_max
        if out.shape[-1] == 3:
            out[..., 1] *= m.g_max
            out[..., 2] *= m.kappa_max
        return out
    if kind == "F":
        return np.moveaxis(stats["F"].denormalize(np.moveaxis(preds_norm, -1, 1)), 1, -1)
    out = np.empty_like(preds_norm)
    out[..., 0] = stats["potential"].denormalize(preds_norm[..., 0])
    if kind == "fpe1d":
        drag = preds_norm[..., 1]
        out[..., 1] = (stats["drag"].denormalize(drag.mean(axis=1, keepdims=True))
                       * np.ones_like(drag))
    else:
        out[..., 1] = stats["drag"].denormalize(preds_norm[..., 1])
    return out


def _rel_l2(preds, targets):
    return relative_l2_per_field(torch.from_numpy(preds), torch.from_numpy(targets), True).numpy()


def evaluate_suite_model(spec, model_name: str, workdir: str, batch: int = 16,
                         save_predictions: bool = True, make_figures: bool = True,
                         device=None):
    """Returns a report dict; writes metrics.csv and predictions.npy under
    ``{workdir}/eval/{suite}_{model}/``. The model runs on ``device`` (CUDA unless the
    caller passes another). With ``make_figures`` it also draws the first three test
    samples (``pred_sample_{i}.png``) and the report's ``figures`` entry lists their
    paths, or says in words that matplotlib cannot be imported; any other plotting error
    propagates."""
    dev = default_device(device)
    train_ds = cached_train_stats(spec, workdir)
    test = _load_npz(os.path.join(workdir, "data", spec.test_file))
    inputs = normalized_test_inputs(train_ds, test)

    ckpt = load_best(os.path.join(workdir, "ckpt", f"{spec.name}_{model_name}"), dev)
    model = spec.models[model_name](device=dev)
    model.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]})
    model.eval()
    preds_norm = predict_fields(model, inputs, spec.grid, batch, dev)

    out_dir = os.path.join(workdir, "eval", f"{spec.name}_{model_name}")
    os.makedirs(out_dir, exist_ok=True)

    # normalized-space per-sample metrics against the test targets
    test_ds = _normalized_test_targets(spec, train_ds, test)
    errs = _rel_l2(preds_norm, test_ds)  # (M, F)
    with open(os.path.join(out_dir, "metrics.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["sample"] + [f"rel_l2_field{i}" for i in range(errs.shape[1])] + ["sum"])
        for i, row in enumerate(errs):
            w.writerow([i] + [f"{v:.6f}" for v in row] + [f"{row.sum():.6f}"])

    preds_phys = denormalize_predictions(spec, train_ds, preds_norm)
    if save_predictions:
        np.save(os.path.join(out_dir, "predictions.npy"), preds_phys)

    report = {
        "suite": spec.name,
        "model": model_name,
        "n_test": int(errs.shape[0]),
        "mean_rel_l2_per_field": errs.mean(axis=0).tolist(),
        "mean_rel_l2_sum": float(errs.sum(axis=1).mean()),
        "ckpt_epoch": int(ckpt.get("epoch", -1)),
        "ckpt_test_loss": float(ckpt.get("test_loss", float("nan"))),
    }
    # symmetry test-time ensembling for augmentation-trained suites, reported as an
    # EXTRA column; the headline metrics above stay the plain single-pass numbers
    aug_kind = getattr(getattr(spec, "train_cfg", None), "augment", None)
    if aug_kind:
        errs_tta = _rel_l2(predict_fields_tta(model, inputs, spec.grid, aug_kind, batch, dev),
                           test_ds)
        report["mean_rel_l2_per_field_tta"] = errs_tta.mean(axis=0).tolist()
        report["mean_rel_l2_sum_tta"] = float(errs_tta.sum(axis=1).mean())
    if make_figures:
        report["figures"] = _figures(out_dir, preds_phys, test)
    return report


def _figures(out_dir, preds_phys, test, n_plots: int = 3):
    """Truth against prediction for the first ``n_plots`` samples, one PNG each
    (``blindno/eval/field_eval.py:285-318``): line plots of every field in 1-D (the truth
    of field 0, the potential or V, beside it), ``imshow`` pairs of the two fields in
    2-D. Returns the paths written, or a sentence saying why there are none when
    matplotlib cannot be imported."""
    try:
        import matplotlib
    except ImportError as e:
        return f"not made: matplotlib cannot be imported ({e})"
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = []
    for i in range(min(n_plots, preds_phys.shape[0])):
        n_f = preds_phys.shape[-1]
        if preds_phys.ndim == 3:  # 1-D suites
            fig, axes = plt.subplots(1, n_f, figsize=(5 * n_f, 4))
            axes = np.atleast_1d(axes)
            truth0 = test["potential"][i] if "potential" in test else test["V"][i]
            axes[0].plot(truth0, label="true")
            axes[0].plot(preds_phys[i, :, 0], "--", label="pred")
            axes[0].set_title("field 0")
            axes[0].legend()
            for f in range(1, n_f):
                axes[f].plot(preds_phys[i, :, f], "--", label="pred")
                axes[f].set_title(f"field {f}")
        else:  # 2-D suites
            fig, axes = plt.subplots(2, n_f, figsize=(5 * n_f, 8))
            if "potential" in test:
                truths = [test["potential"][i], test["drag"][i]]
            else:
                truths = [test["F"][i, 0], test["F"][i, 1]]
            for f in range(n_f):
                axes[0, f].imshow(truths[f], origin="lower")
                axes[0, f].set_title(f"true field {f}")
                axes[1, f].imshow(preds_phys[i, ..., f], origin="lower")
                axes[1, f].set_title(f"pred field {f}")
        fig.tight_layout()
        paths.append(os.path.join(out_dir, f"pred_sample_{i}.png"))
        fig.savefig(paths[-1], dpi=100)
        plt.close(fig)
    return paths
