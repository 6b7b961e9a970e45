"""State carried across: lorads_tpu numpy arrays in, tensors out.

Lets a test start the port from the exact state ``lorads_tpu`` holds at
any point of a solve.  Callers pass ``np.asarray`` of the JAX arrays (or
objects whose array attributes convert with ``np.asarray``); nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from lorads_torch.alg.state import FactorVec, LBFGSHistory
from lorads_torch.ops import lp as lp_ops
from lorads_torch.ops import pattern as pat


def bucket_from_numpy(bk, dtype=torch.float64, device="cpu"):
    """The port's bucket from a lorads_tpu BucketData's fields (any B,
    any constraint slots): a DenseBucketData for a dense bucket (a
    rowshard one's row slabs too), else a split BucketData (a summed
    one's shards too, with a diag-identity parent's full diagonal map).
    The port-only arrays (pattern.dense_port_fields,
    pattern.port_fields, pattern.scatter_fields, the tile schedules) are
    built from the same fields (pattern.split_from_layout,
    pattern.dense_from_layout); the bucket is unplaced."""
    if not (bk.dense or bk.split):
        raise NotImplementedError(
            "only dense and split buckets are ported to lorads_torch")
    rowshard = bool(getattr(bk, "rowshard", False))
    shard = dict(summed=bool(getattr(bk, "summed", False)),
                 rowshard=rowshard,
                 n_loc=int(getattr(bk, "n_loc", 0) or 0),
                 diag_parent=bool(getattr(bk, "diag_parent", False)))
    if shard["summed"] or rowshard:
        shard["B_all"] = bk.B
    if bk.dense:
        meta = {k: getattr(bk, k, 0) for k in pat.DENSE_META_FIELDS}
        meta["a_single_dense"] = bool(getattr(bk, "a_single_dense",
                                              False))
        names = pat.DENSE_FIELDS + (pat.DENSE_DD_FIELDS
                                    if meta["a_single_dense"] else ())
        arrays = {k: np.asarray(getattr(bk, k)) for k in names}
        return pat.dense_from_layout(meta, arrays, dtype, device, **shard)
    meta = {k: getattr(bk, k) for k in pat.META_FIELDS if k != "Ks"}
    arrays = {k: np.asarray(getattr(bk, k))
              for k in pat.INT_FIELDS + pat.FLOAT_FIELDS}
    full = (np.asarray(bk.a_val_d_full) if shard["diag_parent"]
            else None)
    return pat.split_from_layout(meta, arrays, dtype, device,
                                 a_val_d_full=full, **shard)


def lp_from_numpy(lpd, dtype=torch.float64, device="cpu") -> lp_ops.LPData:
    """The port's LP block from a lorads_tpu LPData's fields."""
    arrays = {k: getattr(lpd, k) for k in ("n_cols", "m_glob", "nnz",
                                           "max_nnz_col")}
    arrays.update({k: np.asarray(getattr(lpd, k))
                   for k in lp_ops.LP_INT_FIELDS + lp_ops.LP_FLOAT_FIELDS})
    return lp_ops.lp_from_arrays(arrays, dtype, device)


def _tensor(x, dtype, device):
    return torch.as_tensor(np.array(x, dtype=np.float64),
                           device=device).to(dtype)


def factor_from_numpy(cones, lp, dtype=torch.float64,
                      device="cpu") -> FactorVec:
    """FactorVec from per-bucket [B, n, r] arrays and the LP columns."""
    return FactorVec(tuple(_tensor(x, dtype, device) for x in cones),
                     _tensor(lp, dtype, device))


def state_from_numpy(R=None, U=None, V=None, dual=None, hist=None,
                     dtype=torch.float64, device="cpu") -> dict:
    """The port's tensors for lorads_tpu's solver state.

    ``R``, ``U``, ``V``: FactorVec-likes (``.cones``, ``.lp``); ``dual``:
    the m-vector; ``hist``: an LBFGSHistory-like (``.s``, ``.y``,
    ``.beta``, ``.head``, ``.n_valid``).  Returns a dict with the same
    keys, absent inputs left out."""
    out = {}
    for name, fv in (("R", R), ("U", U), ("V", V)):
        if fv is not None:
            out[name] = factor_from_numpy(fv.cones, fv.lp, dtype, device)
    if dual is not None:
        out["dual"] = _tensor(dual, dtype, device)
    if hist is not None:
        out["hist"] = LBFGSHistory(
            s=factor_from_numpy(hist.s.cones, hist.s.lp, dtype, device),
            y=factor_from_numpy(hist.y.cones, hist.y.lp, dtype, device),
            beta=_tensor(hist.beta, dtype, device),
            head=torch.tensor(int(np.asarray(hist.head)), device=device),
            n_valid=torch.tensor(int(np.asarray(hist.n_valid)),
                                 device=device))
    return out
