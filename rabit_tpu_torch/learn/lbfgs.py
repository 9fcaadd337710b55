"""Vector-free distributed L-BFGS (+ OWL-QN for L1) solver.

PyTorch-port counterpart of :mod:`rabit_tpu.learn.lbfgs` (its own copy:
the port imports nothing of the JAX package).  The solver's state and
its direction math are float64 numpy on the host, line for line the
reference's, so both packages take the same branches on the same
inputs; the objective's ``eval``/``calc_grad`` are where the device
work is (:mod:`rabit_tpu_torch.learn.linear`).

Parallel decomposition (the reference's, rabit-learn/solver/lbfgs.h):
each rank owns one contiguous, 8-aligned **parameter-range shard**; the
(s, y) history lives only as shards; the two-loop recursion runs on dot
products computed on the shards and summed with one allreduce, so no
rank materialises another's history; the direction is assembled
shard-locally and completed with an allreduce.  Solver state is
committed as a (global, local) checkpoint pair: the global state and
the weights global, the history shard local.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

import rabit_tpu_torch
from rabit_tpu_torch.ops import SUM
from rabit_tpu_torch.utils.checks import check


class ObjFunction(ABC):
    """Objective contract.  ``eval``/``calc_grad`` see only this rank's
    data shard; the solver allreduces.  ``save_state``/``load_state``
    let the objective persist extra state inside the solver
    checkpoint."""

    @abstractmethod
    def eval(self, weight: np.ndarray) -> float: ...

    @abstractmethod
    def calc_grad(self, weight: np.ndarray) -> np.ndarray: ...

    @abstractmethod
    def init_num_dim(self) -> int: ...

    @abstractmethod
    def init_model(self, weight: np.ndarray) -> None: ...

    def save_state(self) -> object:
        return None

    def load_state(self, state: object) -> None:
        pass


def _gram(hist: np.ndarray) -> np.ndarray:
    """Gram matrix of the history rows, in float64 on the host: the
    curvature ratios need the full float64 the solver state carries."""
    return hist @ hist.T


class LBFGSSolver:
    """History layout: rows [0, m) are s-vectors (weight deltas), rows
    [m, 2m) y-vectors (gradient deltas), row 2m the current
    steepest-descent proposal, rolled by ``offset``; ``dot_buf`` caches
    the Gram matrix of those rows across shifts."""

    def __init__(self, obj: Optional[ObjFunction] = None):
        self.obj = obj
        # hyper-parameters (the reference's defaults)
        self.reg_L1 = 0.0
        self.max_linesearch_iter = 100
        self.linesearch_backoff = 0.5
        self.linesearch_c1 = 1e-4
        self.min_lbfgs_iter = 5
        self.max_lbfgs_iter = 500
        self.lbfgs_stop_tol = 1e-5
        self.silent = 0
        self.size_memory = 10
        # global state
        self.num_dim = 0
        self.num_iteration = 0
        self.init_objval = 0.0
        self.old_objval = 0.0
        self.new_objval = 0.0
        self.weight: np.ndarray | None = None
        # rolling history
        self.hist: np.ndarray | None = None     # (2m+1, nsub) float64
        self.num_useful = 0
        self.offset = 0
        self.dot_buf: np.ndarray | None = None  # (2m+1, 2m+1) float64
        self.range_begin = 0
        self.range_end = 0

    # ------------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        """Untyped name=value config; unknown names are ignored."""
        if name == "num_dim":
            self.num_dim = int(val)
        elif name == "size_memory":
            self.size_memory = int(val)
        elif name == "reg_L1":
            self.reg_L1 = float(val)
        elif name == "lbfgs_stop_tol":
            self.lbfgs_stop_tol = float(val)
        elif name == "linesearch_backoff":
            self.linesearch_backoff = float(val)
        elif name == "max_linesearch_iter":
            self.max_linesearch_iter = int(val)
        elif name == "max_lbfgs_iter":
            self.max_lbfgs_iter = int(val)
        elif name == "min_lbfgs_iter":
            self.min_lbfgs_iter = int(val)
        elif name == "linesearch_c1":
            self.linesearch_c1 = float(val)
        elif name == "silent":
            self.silent = int(val)

    # ------------------------------------------------------------------
    # rolling-array indexing
    def _map(self, i: int) -> int:
        m = self.size_memory
        if i == 2 * m:
            return i
        if i < m:
            return (i + self.offset) % m
        return (i + self.offset) % m + m

    def _row(self, i: int) -> np.ndarray:
        return self.hist[self._map(i)]

    def _dot(self, i: int, j: int) -> float:
        return self.dot_buf[self._map(i), self._map(j)]

    def _set_dot(self, i: int, j: int, v: float) -> None:
        a, b = self._map(i), self._map(j)
        self.dot_buf[a, b] = v
        self.dot_buf[b, a] = v

    def _shift(self) -> None:
        self.offset = (self.offset + 1) % self.size_memory

    # ------------------------------------------------------------------
    def init(self) -> None:
        """Restore from the latest checkpoint, or initialise."""
        check(self.obj is not None, "LBFGSSolver.init: set an objective first")
        version, gstate, hist = rabit_tpu_torch.load_checkpoint(
            with_local=True)
        if version == 0:
            self.num_dim = self.obj.init_num_dim()
        else:
            self._restore_global(gstate)
        # parameter partition: contiguous, 8-aligned upper split
        nproc = rabit_tpu_torch.get_world_size()
        rank = rabit_tpu_torch.get_rank()
        step = (self.num_dim + nproc - 1) // nproc
        step = (step + 7) // 8 * 8
        self.range_begin = min(rank * step, self.num_dim)
        self.range_end = min((rank + 1) * step, self.num_dim)
        nsub = self.range_end - self.range_begin
        if version == 0:
            m = self.size_memory
            self.dot_buf = np.zeros((2 * m + 1, 2 * m + 1), np.float64)
            self.hist = np.zeros((2 * m + 1, nsub), np.float64)
            self.weight = np.zeros(self.num_dim, np.float64)
            self.obj.init_model(self.weight)
            # all ranks adopt rank 0's initialisation
            self.weight = rabit_tpu_torch.broadcast(
                self.weight if rank == 0 else None, 0)
            self.old_objval = self._eval(self.weight)
            self.init_objval = self.old_objval
            if self.silent == 0 and rank == 0:
                rabit_tpu_torch.tracker_print(
                    "L-BFGS solver starts, num_dim=%d, init_objval=%g, "
                    "size_memory=%d"
                    % (self.num_dim, self.init_objval, self.size_memory))
        else:
            self._restore_local(hist)
            if self.silent == 0 and rank == 0:
                rabit_tpu_torch.tracker_print(
                    "restart from version=%d" % version)

    # -- checkpoint payloads -------------------------------------------
    def _global_payload(self) -> dict:
        return {
            "size_memory": self.size_memory,
            "num_iteration": self.num_iteration,
            "num_dim": self.num_dim,
            "init_objval": self.init_objval,
            "old_objval": self.old_objval,
            "offset": self.offset,
            "dot_buf": self.dot_buf,
            "weight": self.weight,
            "obj_state": self.obj.save_state(),
        }

    def _restore_global(self, payload: dict) -> None:
        self.size_memory = payload["size_memory"]
        self.num_iteration = payload["num_iteration"]
        self.num_dim = payload["num_dim"]
        self.init_objval = payload["init_objval"]
        self.old_objval = payload["old_objval"]
        self.offset = payload["offset"]
        self.dot_buf = payload["dot_buf"]
        self.weight = payload["weight"]
        self.obj.load_state(payload["obj_state"])

    def _local_payload(self) -> dict:
        return {"hist": self.hist, "num_useful": self.num_useful}

    def _restore_local(self, payload: Optional[dict]) -> None:
        nsub = self.range_end - self.range_begin
        if payload is None:
            # local state lost beyond replication reach: restart the
            # history cold (the reference's C++ solver would abort)
            self.hist = np.zeros(
                (2 * self.size_memory + 1, nsub), np.float64)
            self.num_useful = 0
            return
        self.hist = payload["hist"]
        self.num_useful = payload["num_useful"]

    # ------------------------------------------------------------------
    def update_one_iter(self) -> bool:
        """One outer iteration; True when the solver has converged."""
        grad = self.obj.calc_grad(self.weight).astype(np.float64)
        # codec=False on every solver collective: the direction math is
        # precision-critical (curvature ratios of near-equal dots)
        grad = rabit_tpu_torch.allreduce(grad, SUM, codec=False)
        dir_, vdot = self._find_change_direction(grad)
        if vdot >= -1e-15:
            # the (sub)gradient direction vanished: already at the
            # optimum, a stop rather than an error
            self.new_objval = self.old_objval
            return True
        iters, new_weight = self._backtrack_line_search(dir_, vdot)
        check(iters < self.max_linesearch_iter, "line search failed")
        self.weight = new_weight
        if self.num_iteration > self.min_lbfgs_iter:
            if (self.old_objval - self.new_objval
                    < self.lbfgs_stop_tol * self.init_objval):
                return True
        if self.silent == 0 and rabit_tpu_torch.get_rank() == 0:
            rabit_tpu_torch.tracker_print(
                "[%d] L-BFGS: linesearch finishes in %d rounds, "
                "new_objval=%g, improvement=%g"
                % (self.num_iteration, iters, self.new_objval,
                   self.old_objval - self.new_objval))
        self.old_objval = self.new_objval
        rabit_tpu_torch.checkpoint(self._global_payload(),
                                   self._local_payload())
        return False

    def run(self) -> None:
        """Optimise to convergence or ``max_lbfgs_iter``."""
        self.init()
        while self.num_iteration < self.max_lbfgs_iter:
            if self.update_one_iter():
                break
        if self.silent == 0 and rabit_tpu_torch.get_rank() == 0:
            nonzero = int(np.count_nonzero(self.weight))
            rabit_tpu_torch.tracker_print(
                "L-BFGS: finishes at iteration %d, %d/%d active weights"
                % (self.num_iteration, nonzero, self.num_dim))

    def get_weight(self) -> np.ndarray:
        return self.weight

    # ------------------------------------------------------------------
    def _find_change_direction(self, grad: np.ndarray):
        """Vector-free two-loop recursion on shard dot products."""
        m = self.size_memory
        n = self.num_useful
        lo, hi = self.range_begin, self.range_end
        gsub = grad[lo:hi]
        dir_ = np.zeros(self.num_dim, np.float64)
        if n != 0:
            # hist[m+n-1] holds the previous gradient shard: turn it
            # into the newest y-vector
            self.hist[self._map(m + n - 1)] = gsub - self._row(m + n - 1)
            self.hist[self._map(2 * m)] = self._l1_dir(
                gsub, self.weight[lo:hi])
            # Gram products of all history rows in one matmul, then one
            # allreduce of the entries the recursion needs
            gram = _gram(self.hist)
            idxset = ([(j, 2 * m) for j in range(n)]
                      + [(j, n - 1) for j in range(n)]
                      + [(j, m + n - 1) for j in range(n)]
                      + [(m + j, 2 * m) for j in range(n)]
                      + [(m + j, m + n - 1) for j in range(n)])
            vals = np.array(
                [gram[self._map(i), self._map(j)] for i, j in idxset])
            vals = rabit_tpu_torch.allreduce(vals, SUM, codec=False)
            for (i, j), v in zip(idxset, vals):
                self._set_dot(i, j, v)
            # two-loop recursion in dot space
            alpha = np.zeros(n)
            delta = np.zeros(2 * m + 1)
            delta[2 * m] = 1.0
            for j in range(n - 1, -1, -1):
                vsum = sum(delta[k] * self._dot(k, j)
                           for k in range(2 * m + 1))
                alpha[j] = vsum / self._dot(j, m + j)
                delta[m + j] -= alpha[j]
            scale = (self._dot(n - 1, m + n - 1)
                     / self._dot(m + n - 1, m + n - 1))
            delta *= scale
            for j in range(n):
                vsum = sum(delta[k] * self._dot(k, m + j)
                           for k in range(2 * m + 1))
                beta = vsum / self._dot(j, m + j)
                delta[j] += alpha[j] - beta
            # assemble the shard's direction: one (2m+1)-row matvec
            delta_phys = np.zeros(2 * m + 1)
            for i in range(2 * m + 1):
                delta_phys[self._map(i)] = delta[i]
            dirsub = delta_phys @ self.hist
            steep = self._row(2 * m)
            if self.reg_L1 != 0.0:
                dirsub = np.where(dirsub * steep <= 0.0, 0.0, dirsub)
            vdot = -float(dirsub @ steep)
            dir_[lo:hi] = dirsub
            # the iteration's big wire op (num_dim + 1 doubles), issued
            # async and unbucketed while the history shift below runs
            both_handle = rabit_tpu_torch.allreduce_async(
                np.concatenate([dir_, [vdot]]), SUM, fuse=False,
                codec=False)
        else:
            dir_ = self._l1_dir(grad, self.weight)
            vdot = -float(dir_ @ dir_)
            both_handle = None
        # shift the history: a full one discards its oldest (s, y) pair
        # and rotates dot_buf with it
        if n < m:
            n += 1
        else:
            self._shift()
        self.num_useful = n
        self.hist[self._map(m + n - 1)] = gsub
        if both_handle is not None:
            both = both_handle.wait()
            dir_, vdot = both[:-1], float(both[-1])
        return dir_, vdot

    def _backtrack_line_search(self, dir_: np.ndarray, vdot: float):
        """Armijo backtracking; the first iteration takes a unit-norm
        step with a backoff of 0.1."""
        check(vdot < 0.0, "gradient error, dotv=%g", vdot)
        alpha = 1.0
        backoff = self.linesearch_backoff
        if self.num_iteration == 0:
            alpha = 1.0 / np.sqrt(-vdot)
            backoff = 0.1
        iters = 0
        c1 = self.linesearch_c1
        new_weight = self.weight
        while True:
            iters += 1
            if iters >= self.max_linesearch_iter:
                break
            new_weight = self.weight + dir_ * alpha
            if self.reg_L1 != 0.0:
                # OWL-QN: clamp sign flips
                new_weight = np.where(
                    new_weight * self.weight < 0.0, 0.0, new_weight)
            new_val = self._eval(new_weight)
            if new_val - self.old_objval <= c1 * vdot * alpha:
                self.new_objval = new_val
                break
            alpha *= backoff
        lo, hi = self.range_begin, self.range_end
        self.hist[self._map(self.num_useful - 1)] = (
            new_weight[lo:hi] - self.weight[lo:hi])
        self.num_iteration += 1
        return iters, new_weight

    def _l1_dir(self, grad: np.ndarray, weight: np.ndarray) -> np.ndarray:
        """Steepest descent with the L1 subgradient."""
        if self.reg_L1 == 0.0:
            return -grad
        r = self.reg_L1
        pos = -grad - r
        neg = -grad + r
        at_zero = np.where(grad < -r, pos, np.where(grad > r, neg, 0.0))
        return np.where(weight > 0.0, pos,
                        np.where(weight < 0.0, neg, at_zero))

    def _eval(self, weight: np.ndarray) -> float:
        """Global objective: the allreduced data term plus L1."""
        val = float(self.obj.eval(weight))
        val = float(rabit_tpu_torch.allreduce(np.array([val]), SUM,
                                              codec=False)[0])
        if self.reg_L1 != 0.0:
            val += self.reg_L1 * float(np.abs(weight).sum())
        check(not np.isnan(val), "nan occurs")
        return val
