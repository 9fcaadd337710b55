"""Data utilities: CSR matrix, padded-ELL layout, feature hashing and the
LibSVM loader.

PyTorch-port copy of :mod:`rabit_tpu.learn.data` (numpy only), kept
bit-compatible with it: the same ELL padding, the same hash, the same
text format for saved matrices.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from rabit_tpu_torch.utils.checks import check


@dataclass
class SparseMat:
    """CSR sparse matrix with labels."""

    indptr: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))    # (nrow+1,)
    findex: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))    # (nnz,)
    fvalue: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))  # (nnz,)
    labels: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))  # (nrow,)
    feat_dim: int = 0

    @property
    def num_row(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.findex)

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(findex, fvalue) of row i."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.findex[lo:hi], self.fvalue[lo:hi]

    def to_ell(self, pad_index: int | None = None,
               row_block: int | None = None):
        """Padded ELL arrays ``(indices, values, labels, valid)``.

        ``indices``/``values`` are (nrow_padded, max_nnz); padding entries
        carry ``pad_index`` (default ``feat_dim``) and value 0.  With
        ``row_block``, nrow pads up to a multiple of it with all-padding
        rows of validity 0.
        """
        if pad_index is None:
            pad_index = self.feat_dim
        nrow = self.num_row
        counts = np.diff(self.indptr)
        max_nnz = max(1, int(counts.max()) if nrow else 1)
        nrow_pad = nrow
        if row_block:
            nrow_pad = -(-max(nrow, 1) // row_block) * row_block
        uniform = bool(nrow) and self.nnz == nrow * max_nnz
        if uniform and nrow_pad == nrow:
            # every row is full and no row padding is needed: CSR is
            # already ELL, so reshape without a copy
            idx = np.ascontiguousarray(
                self.findex.reshape(nrow, max_nnz), np.int32)
            val = np.ascontiguousarray(
                self.fvalue.reshape(nrow, max_nnz), np.float32)
        elif uniform:
            idx = np.full((nrow_pad, max_nnz), pad_index, np.int32)
            val = np.zeros((nrow_pad, max_nnz), np.float32)
            idx[:nrow] = self.findex.reshape(nrow, max_nnz)
            val[:nrow] = self.fvalue.reshape(nrow, max_nnz)
        else:
            idx = np.full((nrow_pad, max_nnz), pad_index, np.int32)
            val = np.zeros((nrow_pad, max_nnz), np.float32)
            if self.nnz:
                rows = np.repeat(np.arange(nrow), counts)
                offs = (np.arange(self.nnz)
                        - np.repeat(self.indptr[:-1], counts))
                idx[rows, offs] = self.findex
                val[rows, offs] = self.fvalue
        labels = np.zeros(nrow_pad, np.float32)
        labels[:nrow] = self.labels
        valid = np.zeros(nrow_pad, np.float32)
        valid[:nrow] = 1.0
        return idx, val, labels, valid

    def to_dense(self) -> np.ndarray:
        """Densify (small data only); duplicate indices within a row add."""
        out = np.zeros((self.num_row, self.feat_dim), np.float32)
        rows = np.repeat(np.arange(self.num_row), np.diff(self.indptr))
        np.add.at(out, (rows, self.findex), self.fvalue)
        return out


def hash_features(findex: np.ndarray, fvalue: np.ndarray, d_out: int,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Signed feature hashing into ``[0, d_out)`` (``d_out`` a power of
    two), the same mix as the JAX package's, so both packages hash a
    feature to the same slot and sign.  Returns ``(index, signed_value)``;
    collisions within a row add."""
    check(d_out > 0 and (d_out & (d_out - 1)) == 0,
          "hash_features: d_out must be a power of two, got %d", d_out)
    h = findex.astype(np.uint32)
    h ^= np.uint32((seed * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    idx = (h & np.uint32(d_out - 1)).astype(np.int32)
    sign = np.where((h >> np.uint32(31)) & np.uint32(1),
                    np.float32(-1.0), np.float32(1.0))
    return idx, (fvalue.astype(np.float32) * sign)


def load_libsvm(fname: str, rank: int | None = None) -> SparseMat:
    """Load LibSVM-format data.  ``"stdin"`` reads standard input, and a
    printf int field in the name is replaced by the caller's rank.
    ``feat_dim`` is this shard's max feature index + 1."""
    if fname == "stdin":
        text = sys.stdin.read()
    else:
        if "%" in fname:
            if rank is None:
                import rabit_tpu_torch

                rank = rabit_tpu_torch.get_rank()
            fname = fname % rank
        with open(fname) as f:
            text = f.read()

    indptr = [0]
    findex: list[int] = []
    fvalue: list[float] = []
    labels: list[float] = []
    feat_dim = 0
    for tok in text.split():
        if ":" in tok:
            fi, fv = tok.split(":", 1)
            fi = int(fi)
            findex.append(fi)
            fvalue.append(float(fv))
            feat_dim = max(feat_dim, fi)
        else:
            if labels:
                indptr.append(len(findex))
            labels.append(float(tok))
    check(bool(labels), "load_libsvm: no rows in %s", fname)
    indptr.append(len(findex))
    return SparseMat(
        indptr=np.asarray(indptr, np.int64),
        findex=np.asarray(findex, np.int32),
        fvalue=np.asarray(fvalue, np.float32),
        labels=np.asarray(labels, np.float32),
        feat_dim=feat_dim + 1,
    )


def save_matrix_txt(mat: np.ndarray, fname: str,
                    header: str | None = None) -> None:
    """Write a dense matrix as whitespace text (``stdout`` supported);
    ``header`` prepends one ``#``-comment line."""
    out = sys.stdout if fname == "stdout" else open(fname, "w")
    try:
        if header is not None:
            out.write(f"# {header}\n")
        for row in np.atleast_2d(mat):
            out.write(" ".join(f"{v:g}" for v in row) + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
