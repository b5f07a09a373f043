"""The dataset front door and the search's dataset container
(counterpart of ``symbolicregression_jl_tpu/models/dataset.py``).

``validate_dataset`` and ``sanitize_dataset`` are host-side numpy, a copy
of the JAX package's: the census of non-finite cells, degenerate columns
and scale hazards, and ``Options.data_policy``'s reject / mask / repair,
applied before any tensor reaches the device. ``Dataset`` holds X
(nfeatures, n), y (n,) and the optional weights as torch tensors in the
working dtype on the search's device, with the weighted mean of y and the baseline loss of
the constant predictor, which normalises every score.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.losses import resolve_loss
from ..utils.device import resolve_device

# |value| above this in a float32 search is a scale hazard: one squaring
# (the single most common GP sub-expression) overflows to inf, so every
# tree touching the column scores the inf sentinel. sqrt(f32 max) ~ 1.8e19.
SCALE_HAZARD_ABS = float(np.sqrt(np.finfo(np.float32).max))


class HostileDatasetError(ValueError):
    """Raised by ``sanitize_dataset`` under ``data_policy='reject'`` when
    validation finds hard errors. Carries the full structured report in
    ``.diagnostics`` so a job server can return it to the tenant instead
    of a stringified traceback."""

    def __init__(self, message: str, diagnostics: "DatasetDiagnostics"):
        super().__init__(message)
        self.diagnostics = diagnostics


@dataclasses.dataclass
class DatasetDiagnostics:
    """Structured result of :func:`validate_dataset` — the machine-readable
    half of the hostile-data front door (docs/robustness_numeric.md).

    ``errors`` are findings that poison a search outright (non-finite
    cells, no usable rows, degenerate weights): fatal under
    ``data_policy='reject'``, repaired/masked under the other policies.
    ``warnings`` are findings a search survives but an operator should
    see (constant target, degenerate feature columns, scale hazards):
    reported under every policy, never fatal."""

    n_rows: int = 0
    n_features: int = 0
    n_outputs: int = 1
    # non-finite census
    nonfinite_x_cells: int = 0
    nonfinite_y_cells: int = 0
    nonfinite_weight_cells: int = 0
    bad_rows: int = 0              # rows with ANY non-finite cell
    bad_row_fraction: float = 0.0
    # degeneracy
    constant_y_outputs: List[int] = dataclasses.field(default_factory=list)
    degenerate_features: List[int] = dataclasses.field(default_factory=list)
    duplicate_rows: int = 0
    # dtype/scale hazards
    scale_hazard_features: List[int] = dataclasses.field(
        default_factory=list
    )
    scale_hazard_y: bool = False
    # finite input values that became non-finite in the working dtype
    # (e.g. float64 1e40 cast to float32): stamped by equation_search's
    # front door so the report names the cast, not phantom NaN/Inf in
    # the caller's data
    cast_overflow_cells: int = 0
    nonpositive_weights: int = 0
    # verdicts
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)
    # what sanitize_dataset actually did (policy provenance)
    policy: Optional[str] = None
    masked_rows: int = 0
    repaired_cells: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def validate_dataset(X, ys, weights=None) -> DatasetDiagnostics:
    """Host-side (numpy) validation of a search dataset: the front door
    every ``equation_search`` call passes through BEFORE any tensor
    reaches the device. X is (nfeatures, n); ys is (n,) or (nout, n);
    weights optional (n,). Read-only — returns the census, never
    modifies (``sanitize_dataset`` acts on it)."""
    X = np.asarray(X)
    ys = np.asarray(ys)
    if ys.ndim == 1:
        ys = ys[None, :]
    w = None if weights is None else np.asarray(weights)
    d = DatasetDiagnostics(
        n_rows=int(X.shape[1]), n_features=int(X.shape[0]),
        n_outputs=int(ys.shape[0]),
    )

    if w is not None and w.shape != (d.n_rows,):
        # a malformed weights vector is exactly the class of hostile
        # tenant input the front door exists to diagnose — report it
        # structurally instead of letting the census crash on a raw
        # numpy broadcast error
        d.errors.append(
            f"weights shape {tuple(w.shape)} must be (n,) = "
            f"({d.n_rows},)"
        )
        w = None  # weight-dependent census skipped

    fin_x = np.isfinite(X)
    fin_y = np.isfinite(ys)
    d.nonfinite_x_cells = int((~fin_x).sum())
    d.nonfinite_y_cells = int((~fin_y).sum())
    bad_row = ~fin_x.all(axis=0) | ~fin_y.all(axis=0)
    if w is not None:
        fin_w = np.isfinite(w)
        d.nonfinite_weight_cells = int((~fin_w).sum())
        d.nonpositive_weights = int((w[fin_w] < 0).sum())
        bad_row = bad_row | ~fin_w
    d.bad_rows = int(bad_row.sum())
    d.bad_row_fraction = (
        d.bad_rows / d.n_rows if d.n_rows else 0.0
    )

    # --- hard errors: data that poisons every tree's evaluation ---
    if d.n_rows == 0:
        d.errors.append("dataset has zero rows")
    if d.nonfinite_x_cells:
        d.errors.append(
            f"{d.nonfinite_x_cells} non-finite cell(s) in X "
            f"({d.bad_rows} row(s) affected): every tree touching them "
            "evaluates non-finite and scores the inf sentinel"
        )
    if d.nonfinite_y_cells:
        d.errors.append(
            f"{d.nonfinite_y_cells} non-finite target value(s): the "
            "elementwise loss is non-finite on those rows for every tree"
        )
    if d.nonfinite_weight_cells:
        d.errors.append(
            f"{d.nonfinite_weight_cells} non-finite weight(s)"
        )
    if d.nonpositive_weights:
        d.errors.append(
            f"{d.nonpositive_weights} negative weight(s): weighted-mean "
            "aggregation is undefined for them"
        )
    if d.n_rows and d.bad_rows == d.n_rows:
        d.errors.append("every row has a non-finite cell — no usable rows")
    if w is not None and d.n_rows:
        finite_w = w[np.isfinite(w)]
        if finite_w.size and not (finite_w > 0).any():
            d.errors.append(
                "weights sum to zero: no row carries loss weight"
            )

    # --- warnings: survivable but worth an operator's attention ---
    good = ~bad_row
    for j in range(d.n_outputs):
        yj = ys[j][good]
        yj = yj[np.isfinite(yj)]
        if yj.size and float(yj.max() - yj.min()) == 0.0:
            d.constant_y_outputs.append(j)
    if d.constant_y_outputs:
        outs = d.constant_y_outputs
        d.warnings.append(
            f"constant target (zero variance) on output(s) {outs}: the "
            "baseline predictor is already exact; baseline loss falls "
            "back to 1.0 and scores are uninformative"
        )
    for i in range(d.n_features):
        col = X[i][good] if d.n_rows else X[i]
        col = col[np.isfinite(col)]
        if col.size == 0 or float(col.max() - col.min()) == 0.0:
            d.degenerate_features.append(i)
    if d.degenerate_features:
        d.warnings.append(
            f"degenerate feature column(s) {d.degenerate_features} "
            "(constant or no finite values over the usable rows): they "
            "carry no signal and enlarge the search space"
        )
    for i in range(d.n_features):
        col = X[i][np.isfinite(X[i])]
        if col.size and float(np.abs(col).max()) > SCALE_HAZARD_ABS:
            d.scale_hazard_features.append(i)
    fin_y_vals = ys[np.isfinite(ys)]
    d.scale_hazard_y = bool(
        fin_y_vals.size
        and float(np.abs(fin_y_vals).max()) > SCALE_HAZARD_ABS
    )
    if d.scale_hazard_features or d.scale_hazard_y:
        where = []
        if d.scale_hazard_features:
            where.append(f"feature(s) {d.scale_hazard_features}")
        if d.scale_hazard_y:
            where.append("the target")
        d.warnings.append(
            f"|values| above {SCALE_HAZARD_ABS:.2g} in {' and '.join(where)}:"
            " a single squaring overflows float32 — most trees touching "
            "them will score the inf sentinel (consider rescaling)"
        )
    if 0 < d.n_rows <= 100_000 and d.n_features:
        # duplicate-row census (cheap hash over the usable rows); a
        # heavily duplicated dataset wastes eval rows and biases the loss
        rows = np.ascontiguousarray(X.T)
        uniq = np.unique(
            rows[good] if d.n_rows else rows, axis=0
        ).shape[0]
        d.duplicate_rows = int(max(0, good.sum() - uniq))
        if d.duplicate_rows > good.sum() // 2:
            d.warnings.append(
                f"{d.duplicate_rows} duplicate row(s) among "
                f"{int(good.sum())} usable rows"
            )
    return d


def sanitize_dataset(
    X,
    ys,
    weights,
    policy: str,
    diagnostics: Optional[DatasetDiagnostics] = None,
):
    """Apply ``Options.data_policy`` to a validated dataset. Returns
    ``(X, ys, weights, diagnostics)`` with numpy arrays (dtype preserved).
    A clean dataset passes through UNTOUCHED under every policy — same
    objects, no weights invented — so the clean-data search is
    bit-identical across policies (asserted in tests).

    reject — raise :class:`HostileDatasetError` when validation found
    hard errors (warnings never raise).

    mask — rows with any non-finite cell leave the loss through the
    existing weights path (weight 0) and their cells are replaced with
    finite placeholders (feature-column finite mean; per-output finite
    target mean) so the evaluation of EVERY tree stays finite
    on them; a zero-weight row then contributes exactly 0 to the
    weighted loss sum. Raises only when masking cannot produce a usable
    dataset (all rows bad).

    repair — non-finite X cells are imputed cell-wise with the column's
    finite mean and the row STAYS live (full weight); rows whose target
    or weight is non-finite fall back to masking — a target is never
    invented. Scale hazards are reported, never clamped (legitimate
    wide-range data must not be silently rewritten)."""
    d = diagnostics or validate_dataset(X, ys, weights)
    d.policy = policy
    if policy == "reject":
        if d.errors:
            raise HostileDatasetError(
                "hostile dataset rejected (data_policy='reject'): "
                + "; ".join(d.errors)
                + " — use data_policy='mask' or 'repair' to search "
                "anyway (docs/robustness_numeric.md)",
                d,
            )
        return X, ys, weights, d

    X_in, ys_orig, w_in = X, ys, weights
    X = np.asarray(X)
    ys_in = np.asarray(ys)
    multi = ys_in.ndim == 2
    ys2 = ys_in if multi else ys_in[None, :]
    w = None if weights is None else np.asarray(weights)
    changed = False

    structural = [
        e for e in d.errors
        if "zero rows" in e or "sum to zero" in e
        or "negative weight" in e or "weights shape" in e
        # "no usable rows" is structural for MASK (masking every row
        # leaves nothing) but NOT for repair: cell-wise imputation can
        # bring X-only-bad rows back alive, and the genuinely-unusable
        # outcome (every row still masked after repair) is caught by
        # the no-positively-weighted-rows guard below
        or (policy == "mask" and "no usable rows" in e)
    ]
    if structural:
        raise HostileDatasetError(
            f"dataset unusable under data_policy={policy!r}: "
            + "; ".join(structural),
            d,
        )

    fin_x = np.isfinite(X)
    fin_y = np.isfinite(ys2)
    bad_w = np.zeros(X.shape[1], bool) if w is None else ~np.isfinite(w)

    def _col_fill(row_vals, fin):
        vals = row_vals[fin]
        return vals.mean() if vals.size else np.asarray(0.0, X.dtype)

    if policy == "repair" and not fin_x.all():
        # cell-wise imputation: the row stays live unless y/w is bad
        # too. Only columns that HAVE finite values are imputed (a mean
        # exists to impute FROM); a column with no finite values would
        # be invented data wholesale — its cells stay non-finite and
        # the rows fall through to masking below.
        X = X.copy()
        changed = True
        repaired = 0
        for i in np.where(~fin_x.all(axis=1))[0]:
            if fin_x[i].any():
                repaired += int((~fin_x[i]).sum())
                X[i, ~fin_x[i]] = _col_fill(X[i], fin_x[i])
        d.repaired_cells = repaired
        fin_x = np.isfinite(X)

    # rows that must leave the loss: any remaining non-finite cell
    mask_rows = ~fin_x.all(axis=0) | ~fin_y.all(axis=0) | bad_w
    if mask_rows.any():
        changed = True
        X = X.copy()
        ys2 = ys2.copy()
        for i in range(X.shape[0]):
            col_bad = mask_rows & ~np.isfinite(X[i])
            if col_bad.any():
                X[i, col_bad] = _col_fill(X[i], np.isfinite(X[i]))
        for j in range(ys2.shape[0]):
            row_bad = mask_rows & ~np.isfinite(ys2[j])
            if row_bad.any():
                ys2[j, row_bad] = _col_fill(ys2[j], np.isfinite(ys2[j]))
        if w is None:
            w = np.ones(X.shape[1], X.dtype)
        else:
            w = w.copy()
        w[mask_rows] = 0
        d.masked_rows = int(mask_rows.sum())
        if not (np.asarray(w)[~mask_rows] > 0).any():
            raise HostileDatasetError(
                f"data_policy={policy!r} left no positively-weighted "
                "usable rows",
                d,
            )
    if not changed:
        # clean data passes through UNTOUCHED (the very objects the
        # caller handed in): bit-identity across policies by identity
        return X_in, ys_orig, w_in, d
    return X, (ys2 if multi else ys2[0]), w, d


@dataclasses.dataclass
class Dataset:
    X: torch.Tensor  # (nfeatures, n)
    y: torch.Tensor  # (n,)
    weights: Optional[torch.Tensor] = None  # (n,)
    variable_names: Optional[Tuple[str, ...]] = None
    avg_y: float = 0.0
    baseline_loss: float = 1.0

    @property
    def n(self) -> int:
        return self.X.shape[1]

    @property
    def nfeatures(self) -> int:
        return self.X.shape[0]


def make_dataset(X, y, weights=None,
                 variable_names: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float32,
                 device="cuda") -> Dataset:
    """The arrays as tensors of ``dtype`` on ``device`` (the card unless
    the caller asks for the CPU); ``avg_y`` is the (weighted) mean of y,
    computed in ``dtype`` on the device."""
    dev = resolve_device(device)

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        # through float64 at float64 (float32 for the others, as before)
        host = np.float64 if dtype == torch.float64 else np.float32
        return torch.as_tensor(np.asarray(a, host), device=dev).to(dtype)

    X, y = put(X), put(y)
    if X.dim() != 2:
        raise ValueError("X must be (nfeatures, n)")
    if tuple(y.shape) != (X.shape[1],):
        raise ValueError(f"y shape {tuple(y.shape)} != (n,) = ({X.shape[1]},)")
    w = None
    if weights is not None:
        w = put(weights)
        if w.shape != y.shape:
            raise ValueError("weights must match y shape")
    avg = y.mean() if w is None else (y * w).sum() / w.sum()
    names = tuple(variable_names) if variable_names is not None else None
    if names is not None and len(names) != X.shape[0]:
        raise ValueError("variable_names length must equal nfeatures")
    return Dataset(X=X, y=y, weights=w, variable_names=names,
                   avg_y=float(avg))


def update_baseline_loss(dataset: Dataset, options_or_loss) -> Dataset:
    """Score the constant predictor ``avg_y`` in the working dtype;
    ``baseline_loss`` is 1.0 where that is not finite and positive.
    Accepts an elementwise loss (a registry name or callable) or an
    Options (its ``loss``); with an Options whose ``loss_function`` is set
    the baseline is that objective of the encoded constant tree ``avg_y``
    (the JAX package's rule)."""
    loss_function = getattr(options_or_loss, "loss_function", None)
    if loss_function is not None:
        from .trees import Expr, encode_tree

        options = options_or_loss
        tree = encode_tree(Expr.const(dataset.avg_y), options.max_len,
                           device=dataset.y.device, dtype=dataset.y.dtype)
        tree = tree._replace(cval=tree.cval.to(dataset.y.dtype))
        base = float(loss_function(tree, dataset.X, dataset.y,
                                   dataset.weights, options))
        dataset.baseline_loss = (base if np.isfinite(base) and base > 0
                                 else 1.0)
        return dataset
    loss = getattr(options_or_loss, "loss", options_or_loss)
    elem = resolve_loss(loss)(torch.full_like(dataset.y, dataset.avg_y),
                              dataset.y)
    w = dataset.weights
    base = float(elem.mean() if w is None else (elem * w).sum() / w.sum())
    dataset.baseline_loss = base if np.isfinite(base) and base > 0 else 1.0
    return dataset


def load_csv_dataset(path: str, target: "str | int" = -1,
                     delimiter: Optional[str] = None,
                     weights_column: "Optional[str | int]" = None,
                     dtype: torch.dtype = torch.float32,
                     device="cuda") -> Dataset:
    """A Dataset from a numeric CSV / TSV file: rows are samples, columns
    features; ``target`` picks the y column by header name or index
    (default the last), ``weights_column`` the weights. A header line's
    names become ``variable_names``. Parsed by numpy on the host."""
    with open(path) as f:
        first = f.readline()
    delim = delimiter
    if delim is None:
        # space is a last resort: header names may contain spaces
        delim = max(",;\t", key=first.count) if first else ","
        if first.count(delim) == 0:
            delim = " "
    fields = [c.strip() for c in first.strip().split(delim)]

    def _is_num(s):
        try:
            float(s)
            return True
        except ValueError:
            return False

    names = None
    has_header = any(not _is_num(c) for c in fields if c)
    if has_header:
        # keep positional alignment with data columns; name blanks
        names = [c if c else f"col{i}" for i, c in enumerate(fields)]
    data = np.loadtxt(path, delimiter=None if delim == " " else delim,
                      skiprows=1 if has_header else 0, ndmin=2)
    ncols = data.shape[1]

    def _col_index(sel, what: str) -> int:
        if isinstance(sel, str):
            if names is None or sel not in names:
                raise ValueError(f"No column named {sel!r} in {path!r}")
            return names.index(sel)
        if not -ncols <= sel < ncols:
            raise ValueError(
                f"{what} index {sel} out of range for {ncols} columns")
        return sel % ncols

    t_idx = _col_index(target, "target")
    w_idx = (_col_index(weights_column, "weights_column")
             if weights_column is not None else None)
    feat_idx = [i for i in range(ncols) if i != t_idx and i != w_idx]
    X = data[:, feat_idx].T
    y = data[:, t_idx]
    w = data[:, w_idx] if w_idx is not None else None
    var_names = [names[i] for i in feat_idx] if names is not None else None
    return make_dataset(X, y, w, var_names, dtype=dtype, device=device)
