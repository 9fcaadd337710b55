"""Distributed k-means (cosine distance) on PyTorch, with the per-iteration
statistics pass in the CUDA kernels of :mod:`rabit_tpu_torch.ops.kmeans_kernel`.

Counterpart of :mod:`rabit_tpu.learn.kmeans`, module for module: a shard
is staged on the device once (:func:`prepare_shard`, four tiers), each
iteration computes the (k, d+1) stats matrix (counts in the last
column), allreduces it, updates the centroids and checkpoints.  With
``device_chain > 1`` at world 1 the iterations chain on the device
between checkpoints.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); a missing card is an error, not a fallback.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

import rabit_tpu_torch
from rabit_tpu_torch import engine as _engine_mod
from rabit_tpu_torch.learn.data import (SparseMat, hash_features, load_libsvm,
                                        save_matrix_txt)
from rabit_tpu_torch.ops import MAX, SUM
from rabit_tpu_torch.ops.kmeans_kernel import (kmeans_ell_stats_fused,
                                               kmeans_stats_fused)
from rabit_tpu_torch.utils.checks import check

DEFAULT_ROW_BLOCK = 1024

# Pre-densify the shard (float32, validity in column d) when the dense
# copy fits this budget; each iteration is then plain matrix products.
DENSIFY_BUDGET_BYTES = 2 << 30
# Half-width dense staging (compute_dtype="bfloat16") when no card
# reports its memory.
DENSE16_BUDGET_BYTES = 14 << 30
# The JAX package stages dense16 rows at a 128-lane padded width; the
# port does not pad, but sizes the tier by the same rule so a shard
# picks the same tier in both packages.
_LANE = 128
_STAGE_CHUNK_ROWS = 1 << 20

_ELL_FUSED_BLOCK = 2048
_ELL_FUSED_HI = 128
_ELL_FUSED_GROUP = 4


@dataclass
class KMeansModel:
    """Centroid matrix, checkpointed by value.  ``hash_dim`` records the
    signed-hash width the centroids live in (None = original space)."""

    centroids: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))
    hash_dim: int | None = None

    def normalize(self) -> None:
        """L2-normalize centroid rows; rows of ~zero norm stay unscaled."""
        norm = np.linalg.norm(self.centroids, axis=1, keepdims=True)
        scale = np.where(norm < 1e-6, 1.0, 1.0 / np.maximum(norm, 1e-30))
        self.centroids = (self.centroids * scale).astype(np.float32)


def save_model(model: KMeansModel, fname: str) -> None:
    """Write the centroid matrix as text (the JAX package's format);
    hashed-space models get a ``#`` header naming the hash width."""
    header = (None if model.hash_dim is None
              else "rabit-kmeans hash_dim=%d" % model.hash_dim)
    save_matrix_txt(model.centroids, fname, header=header)


def init_centroids(data: SparseMat, num_cluster: int, feat_dim: int,
                   seed: int = 0) -> KMeansModel:
    """Seed centroids from random data rows, each broadcast from a random
    rank (the same numpy draws as the JAX package)."""
    rng = np.random.default_rng(seed)
    cent = np.zeros((num_cluster, feat_dim), np.float32)
    for i in range(num_cluster):
        fi, fv = data.row(int(rng.integers(data.num_row)))
        np.add.at(cent, (i, fi), fv)      # hashed rows carry duplicates
    for i in range(num_cluster):
        root = int(rng.integers(rabit_tpu_torch.get_world_size()))
        cent[i] = rabit_tpu_torch.broadcast(
            cent[i] if rabit_tpu_torch.get_rank() == root else None, root)
    model = KMeansModel(cent)
    model.normalize()
    return model


def _resolve_device(device) -> torch.device:
    """None means the card.  Asking for CUDA without one is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rabit_tpu_torch k-means runs on a CUDA device "
                           "and none is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _dense16_budget() -> int:
    """Device-memory budget of the dense16 tier: 7/8 of the card's
    memory, else the 14 GiB constant."""
    if torch.cuda.is_available():
        _free, total = torch.cuda.mem_get_info()
        return total - (total >> 3)
    return DENSE16_BUDGET_BYTES


def _densify_rows(idx, val, feat_dim: int, device) -> torch.Tensor:
    """(rows, feat_dim+1) float32 rows from host ELL arrays by
    ``scatter_add_``; pad slots (index feat_dim) land in the last
    column, which callers overwrite or slice away."""
    i = torch.from_numpy(np.ascontiguousarray(idx)).to(device).long()
    v = torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(device)
    dense = torch.zeros((i.shape[0], feat_dim + 1), dtype=torch.float32,
                        device=device)
    return dense.scatter_add_(1, i, v)


def _densify(idx, val, valid, feat_dim: int, row_block: int, device):
    """The dense tier: (nb, row_block, feat_dim+1) float32 blocks whose
    last column is the validity."""
    n = idx.shape[0]
    out = torch.empty((n, feat_dim + 1), dtype=torch.float32, device=device)
    for s in range(0, n, _STAGE_CHUNK_ROWS):
        e = min(n, s + _STAGE_CHUNK_ROWS)
        out[s:e] = _densify_rows(idx[s:e], val[s:e], feat_dim, device)
    out[:, feat_dim] = torch.from_numpy(
        np.ascontiguousarray(valid, np.float32)).to(device)
    return out.view(n // row_block, row_block, feat_dim + 1)


def _stage_dense16(idx, val, valid, feat_dim: int, compute_dtype: str,
                   device):
    """The dense16 tier: an (n, d) ``compute_dtype`` array plus a float32
    validity vector, densified chunk by chunk so peak device memory is
    the output plus one chunk."""
    n = idx.shape[0]
    x = torch.empty((n, feat_dim), dtype=getattr(torch, compute_dtype),
                    device=device)
    for s in range(0, n, _STAGE_CHUNK_ROWS):
        e = min(n, s + _STAGE_CHUNK_ROWS)
        x[s:e] = _densify_rows(idx[s:e], val[s:e], feat_dim,
                               device)[:, :feat_dim]
    v = torch.from_numpy(np.ascontiguousarray(valid, np.float32)).to(device)
    return x, v


def _normalize_rows(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise rows (cosine distance prep)."""
    return m / (torch.linalg.norm(m, dim=1, keepdim=True) + eps)


def _dense_assign(cnorm: torch.Tensor, x: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Shared plain stats core: similarity → argmax → masked one-hot;
    the (rows, k) float32 assignment matrix."""
    assign = (x @ cnorm.T).argmax(dim=1)
    return F.one_hot(assign, cnorm.shape[0]).float() * valid[:, None]


def _dense_stats(centroids: torch.Tensor, blocks: torch.Tensor,
                 d: int) -> torch.Tensor:
    """Stats over pre-densified blocks (validity in column d): two
    matrix products per block, as the JAX package's scan."""
    cnorm = _normalize_rows(centroids)
    acc = torch.zeros((centroids.shape[0], d + 1), dtype=torch.float32,
                      device=blocks.device)
    for dense in blocks:
        onehot = _dense_assign(cnorm, dense[:, :d], dense[:, d])
        acc += onehot.T @ dense
    return acc


def _ell_stats(centroids: torch.Tensor, idx: torch.Tensor,
               val: torch.Tensor, valid: torch.Tensor,
               d: int) -> torch.Tensor:
    """Stats over pre-blocked ELL rows (the ``ell`` tier): densify each
    block by ``scatter_add_``, then the plain core."""
    cnorm = _normalize_rows(centroids)
    acc = torch.zeros((centroids.shape[0], d + 1), dtype=torch.float32,
                      device=idx.device)
    for bi, bv, bvalid in zip(idx, val, valid):
        dense = torch.zeros((bi.shape[0], d + 1), dtype=torch.float32,
                            device=idx.device)
        dense = dense.scatter_add_(1, bi.long(), bv)[:, :d]
        onehot = _dense_assign(cnorm, dense, bvalid)
        ext = torch.cat([dense * bvalid[:, None], bvalid[:, None]], dim=1)
        acc += onehot.T @ ext
    return acc


def centroid_update(cent: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """New centroids from a (k, d+1) stats matrix: divide by counts
    (empty clusters keep their previous centroid), then renormalise."""
    counts = stats[:, -1:]
    new = torch.where(counts > 0, stats[:, :-1] / counts.clamp(min=1.0),
                      cent)
    norm = torch.linalg.norm(new, dim=1, keepdim=True)
    return torch.where(norm < 1e-6, new, new / norm.clamp(min=1e-30))


def device_iterations(centroids: torch.Tensor, x: torch.Tensor,
                      valid: torch.Tensor, iters: int,
                      use_kernel: bool | None = None,
                      block: int | None = None,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """Run ``iters`` k-means iterations on x's device; returns the final
    centroids (a tensor on that device).

    ``use_kernel`` (default: x is on a CUDA device) takes each stats pass
    through :func:`kmeans_stats_fused`; otherwise it is the plain path,
    whose similarity runs in ``compute_dtype`` as the JAX package's
    ``use_pallas=False`` loop does.  Statistics accumulate in float32.
    ``block`` is accepted for the JAX package's signature.
    """
    if use_kernel is None:
        use_kernel = x.is_cuda
    cdt = getattr(torch, compute_dtype)
    x = x.to(cdt)                      # one cast, reused across the chain
    cent = centroids.to(device=x.device, dtype=torch.float32)
    for _ in range(iters):
        if use_kernel:
            stats = kmeans_stats_fused(cent, x, valid)
        else:
            onehot = _dense_assign(_normalize_rows(cent).to(cdt), x, valid)
            sums = onehot.T @ x.float()
            stats = torch.cat([sums, onehot.sum(dim=0)[:, None]], dim=1)
        cent = centroid_update(cent, stats)
    return cent


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def prepare_shard(idx, val, valid, feat_dim: int,
                  row_block: int = DEFAULT_ROW_BLOCK,
                  budget: int = DENSIFY_BUDGET_BYTES,
                  compute_dtype: str = "float32", device=None):
    """Stage this rank's shard on the device for repeated stats passes.

    Tiers, in the JAX package's order: ``dense`` (float32 blocks, within
    ``budget``), ``dense16`` (half-width rows within the card's budget,
    for ``compute_dtype="bfloat16"``), ``ell_fused`` (on a CUDA device:
    grouped ELL rows for the ELL kernel) and ``ell`` (pre-blocked ELL
    rows for the plain path).
    """
    device = _resolve_device(device)
    n = idx.shape[0]
    if n * (feat_dim + 1) * 4 <= budget:
        return ("dense", feat_dim,
                _densify(idx, val, valid, feat_dim, row_block, device))
    if compute_dtype != "float32":
        itemsize = getattr(torch, compute_dtype).itemsize
        dp = -(-feat_dim // _LANE) * _LANE
        if n * dp * itemsize + n * 4 <= _dense16_budget():
            return ("dense16", feat_dim,
                    _stage_dense16(idx, val, valid, feat_dim,
                                   compute_dtype, device))
    if _on_card(device):
        # slots pad to a power of two and rows to the kernel block, as
        # in the JAX package, so the kernel's validation passes; pad
        # slots carry (index feat_dim, value 0)
        nnz = idx.shape[1]
        nnz_p = _next_pow2(nnz)
        n_p = -(-n // _ELL_FUSED_BLOCK) * _ELL_FUSED_BLOCK
        if nnz_p != nnz or n_p != n:
            idx = np.pad(idx, ((0, n_p - n), (0, nnz_p - nnz)),
                         constant_values=feat_dim)
            val = np.pad(val, ((0, n_p - n), (0, nnz_p - nnz)))
            valid = np.pad(valid, (0, n_p - n))
        # the kernel's width is a multiple of hi; clamped out-of-range
        # features that carry values need one more column to absorb them
        contaminated = bool(np.any(val[idx >= feat_dim]))
        d_base = feat_dim + 1 if contaminated else feat_dim
        d_pad = -(-d_base // _ELL_FUSED_HI) * _ELL_FUSED_HI
        g = _ELL_FUSED_GROUP
        idx_g = torch.from_numpy(np.ascontiguousarray(
            idx.reshape(n_p // g, g * nnz_p), np.int32)).to(device)
        val_g = torch.from_numpy(np.ascontiguousarray(
            val.reshape(n_p // g, g * nnz_p), np.float32)).to(device)
        dvalid = torch.from_numpy(
            np.ascontiguousarray(valid, np.float32)).to(device)
        return ("ell_fused", feat_dim, (idx_g, val_g, dvalid, d_pad, nnz_p))
    return ("ell", feat_dim, device_ell(idx, val, valid, row_block, device))


def _shard_device(shard) -> torch.device:
    payload = shard[2]
    return (payload if isinstance(payload, torch.Tensor)
            else payload[0]).device


def shard_stats_device(model: KMeansModel, shard) -> torch.Tensor:
    """Per-iteration (k, d+1) stats for a staged shard, left on the
    shard's device."""
    kind, _feat_dim, payload = shard
    k, d = model.centroids.shape
    cent = torch.from_numpy(model.centroids).to(_shard_device(shard))
    if kind == "dense":
        return _dense_stats(cent, payload, d)
    if kind == "dense16":
        x, v16 = payload
        return kmeans_stats_fused(cent, x, v16)
    if kind == "ell_fused":
        return _ell_fused_stats(cent, payload, d)
    idx, val, valid = payload
    return _ell_stats(cent, idx, val, valid, d)


def _ell_fused_stats(centroids: torch.Tensor, payload, d: int,
                     use_kernel: bool = True) -> torch.Tensor:
    """ELL-kernel stats with the feature padding folded in: centroids
    zero-pad to the kernel's width, the extra columns absorb clamped
    features and are sliced away.  The compute dtype is the kernel's
    default (bfloat16), as in the JAX package, whatever ``run()`` was
    given.  ``use_kernel=False`` runs the kernel's plain version on the
    same tensors."""
    idx_g, val_g, valid, d_pad, nnz = payload
    cent_p = F.pad(centroids, (0, d_pad - d))
    if use_kernel:
        stats = kmeans_ell_stats_fused(
            cent_p, idx_g, val_g, valid, d_pad, nnz=nnz,
            group=_ELL_FUSED_GROUP, hi=_ELL_FUSED_HI, block=_ELL_FUSED_BLOCK)
    else:
        from rabit_tpu_torch.ops import kmeans_kernel as kk

        cn = kk._normalized(cent_p, torch.bfloat16)
        stats = kk._ell_stats_plain(cn, idx_g.reshape(-1, nnz),
                                    val_g.reshape(-1, nnz), valid, d_pad)
    return torch.cat([stats[:, :d], stats[:, -1:]], dim=1)


def ell_chain(centroids: torch.Tensor, payload, d: int, iters: int,
              use_kernel: bool = True) -> torch.Tensor:
    """``iters`` ELL-kernel k-means iterations on the device (the sparse
    twin of :func:`device_iterations`)."""
    cent = centroids
    for _ in range(iters):
        cent = centroid_update(cent, _ell_fused_stats(cent, payload, d,
                                                      use_kernel))
    return cent


def shard_stats(model: KMeansModel, shard) -> np.ndarray:
    """Per-iteration (k, d+1) stats for a staged shard, on the host."""
    return shard_stats_device(model, shard).cpu().numpy()


def device_ell(idx, val, valid, row_block: int = DEFAULT_ROW_BLOCK,
               device=None):
    """Move ELL arrays to the device once, pre-blocked as
    (nb, row_block, ...)."""
    device = _resolve_device(device)
    nb = idx.shape[0] // row_block

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(idx, np.int32).view(nb, row_block, -1),
            put(val, np.float32).view(nb, row_block, -1),
            put(valid, np.float32).view(nb, row_block))


def compute_stats(model: KMeansModel, idx, val, valid,
                  row_block: int = DEFAULT_ROW_BLOCK,
                  device=None) -> np.ndarray:
    """Local (k, d+1) stats of flat host ELL arrays (or the pre-blocked
    tensors of :func:`device_ell`) through the plain ``ell`` path."""
    if not isinstance(idx, torch.Tensor):
        idx, val, valid = device_ell(idx, val, valid, row_block, device)
    k, d = model.centroids.shape
    cent = torch.from_numpy(model.centroids).to(idx.device)
    return _ell_stats(cent, idx, val, valid, d).cpu().numpy()


def run(data: SparseMat, num_cluster: int, max_iter: int,
        out_model: str | None = None, seed: int = 0,
        row_block: int = DEFAULT_ROW_BLOCK,
        device_chain: int = 0,
        hash_dim: int | None = None,
        compute_dtype: str = "float32",
        device=None) -> KMeansModel:
    """Train; the JAX package's ``run`` on PyTorch.

    ``device`` (default: the card) is where the shard lives and the
    stats pass runs.  ``device_chain > 1`` chains that many iterations
    on the device between checkpoints at world 1.  ``hash_dim`` clusters
    in signed-hashed feature space.  ``compute_dtype="bfloat16"`` opens
    the half-width dense16 tier (similarity in bf16, sums in float32).
    """
    device = _resolve_device(device)
    if hash_dim is not None:
        hidx, hval = hash_features(data.findex, data.fvalue, hash_dim)
        data = SparseMat(indptr=data.indptr, findex=hidx, fvalue=hval,
                         labels=data.labels, feat_dim=hash_dim)
    model = KMeansModel()
    version, restored = rabit_tpu_torch.load_checkpoint()
    if version == 0:
        feat_dim = int(rabit_tpu_torch.allreduce(
            np.array([data.feat_dim], np.int64), MAX)[0])
        model = init_centroids(data, num_cluster, feat_dim, seed)
        model.hash_dim = hash_dim
        rabit_tpu_torch.tracker_print(
            "[%d] start at %s" % (
                rabit_tpu_torch.get_rank(),
                rabit_tpu_torch.get_processor_name()))
    else:
        model = restored
        check(getattr(model, "hash_dim", None) == hash_dim,
              "kmeans resume: checkpoint was trained with hash_dim=%s "
              "but run() got hash_dim=%s — centroids live in a different "
              "feature space; pass the original value",
              getattr(model, "hash_dim", None), hash_dim)
        rabit_tpu_torch.tracker_print(
            "[%d] restart iter=%d" % (rabit_tpu_torch.get_rank(), version))
    k, feat_dim = model.centroids.shape
    idx, val, _labels, valid = data.to_ell(
        pad_index=feat_dim, row_block=row_block)
    # clamp out-of-range features (another shard defined feat_dim)
    idx = np.minimum(idx, feat_dim).astype(np.int32)
    shard = prepare_shard(idx, val, valid, feat_dim, row_block,
                          compute_dtype=compute_dtype, device=device)

    if (device_chain > 1 and not rabit_tpu_torch.is_distributed()
            and shard[0] in ("dense", "dense16", "ell_fused")):
        # world 1: chain iterations on the device, syncing to the host
        # only to checkpoint every `device_chain` iterations
        if shard[0] == "dense":
            flat = shard[2].view(-1, feat_dim + 1)
            x, vcol = flat[:, :feat_dim], flat[:, feat_dim]
        elif shard[0] == "dense16":
            x, vcol = shard[2]
        it = version
        cent = torch.from_numpy(model.centroids).to(device)
        while it < max_iter:
            chain = min(device_chain, max_iter - it)
            if shard[0] == "dense":
                cent = device_iterations(cent, x, vcol, chain)
            elif shard[0] == "dense16":
                cent = device_iterations(cent, x, vcol, chain,
                                         compute_dtype=compute_dtype)
            else:
                cent = ell_chain(cent, shard[2], feat_dim, chain)
            it += chain
            model.centroids = cent.cpu().numpy()
            rabit_tpu_torch.checkpoint(model)
        if out_model and rabit_tpu_torch.get_rank() == 0:
            save_model(model, out_model)
        return model

    device_plane = _engine_mod.is_device_plane()
    epoch = rabit_tpu_torch.device_epoch()
    for _ in range(version, max_iter):
        if rabit_tpu_torch.device_epoch() != epoch:
            # the device plane was re-formed: re-stage the shard
            epoch = rabit_tpu_torch.device_epoch()
            shard = prepare_shard(idx, val, valid, feat_dim, row_block,
                                  compute_dtype=compute_dtype, device=device)
        if device_plane:
            local = shard_stats_device(model, shard)
            stats = rabit_tpu_torch.allreduce(local, SUM).cpu().numpy()
        else:
            stats = np.zeros((k, feat_dim + 1), np.float32)

            def lazy_stats(stats=stats, model=model):
                stats[...] = shard_stats(model, shard)

            stats = rabit_tpu_torch.allreduce(stats, SUM,
                                              prepare_fun=lazy_stats)
        counts = stats[:, -1:]
        check(bool((counts != 0).all()), "get zero sized cluster")
        model.centroids = (stats[:, :-1] / counts).astype(np.float32)
        model.normalize()
        rabit_tpu_torch.checkpoint(model)

    if out_model and rabit_tpu_torch.get_rank() == 0:
        save_model(model, out_model)
    return model


def main(argv: list[str]) -> int:
    """CLI: ``kmeans <data> num_cluster max_iter <out_model> [name=value ...]``.

    App keys: ``kmeans_hash_dim=<int>``, ``kmeans_device_chain=<int>``,
    ``kmeans_compute_dtype=float32|bfloat16`` and
    ``kmeans_device=cpu|cuda`` (default cuda); every other pair goes to
    the engine.
    """
    if len(argv) < 5:
        rabit_tpu_torch.init(argv[1:])
        if rabit_tpu_torch.get_rank() == 0:
            rabit_tpu_torch.tracker_print(
                "Usage: <data_dir> num_cluster max_iter <out_model>")
        rabit_tpu_torch.finalize()
        return 0
    import time

    t0 = time.perf_counter()
    app = {}
    engine_args = []
    for a in argv[5:]:
        key, _, v = a.partition("=")
        if key in ("kmeans_hash_dim", "kmeans_device_chain"):
            check(v.isdigit(), "%s needs an integer value, got %r "
                  "(usage: %s=<int>)", key, v, key)
            app[key] = int(v)
        elif key == "kmeans_compute_dtype":
            check(v in ("float32", "bfloat16"),
                  "kmeans_compute_dtype must be float32|bfloat16, got %r",
                  v)
            app[key] = v
        elif key == "kmeans_device":
            check(v in ("cpu", "cuda"),
                  "kmeans_device must be cpu|cuda, got %r", v)
            app[key] = v
        else:
            engine_args.append(a)
    rabit_tpu_torch.init(engine_args)
    data = load_libsvm(argv[1])
    run(data, int(argv[2]), int(argv[3]), argv[4],
        device_chain=app.get("kmeans_device_chain", 0),
        hash_dim=app.get("kmeans_hash_dim"),
        compute_dtype=app.get("kmeans_compute_dtype", "float32"),
        device=app.get("kmeans_device", "cuda"))
    rabit_tpu_torch.tracker_print(
        "[%d] Time taken: %f seconds" % (
            rabit_tpu_torch.get_rank(), time.perf_counter() - t0))
    rabit_tpu_torch.finalize()
    return 0


def cli() -> int:
    """Console-script entry point."""
    return main(sys.argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
