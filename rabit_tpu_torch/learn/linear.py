"""Linear / logistic regression on the L-BFGS solver.

PyTorch-port counterpart of :mod:`rabit_tpu.learn.linear` (its own copy:
the port imports nothing of the JAX package).  The objective's
``eval``/``calc_grad`` run on the device over the padded-ELL rows,
which are staged once and stay resident across the solver's
iterations: margins are a gather and a row sum, the loss is
``log1p``/``exp`` (or the squared error), and the gradient is a 1-D
``index_add_`` of the rows' residual-scaled values into the weight
vector.  Model files keep the reference's two encodings (``binf``
binary and ``bs64`` base64 text), byte for byte, so that a model one
package saves loads in the other.

``linear_device=cpu|cuda`` picks the device; without it the objective
runs on the card, and a missing card is an error, not a fallback.
"""
from __future__ import annotations

import base64
import struct
import sys
from typing import BinaryIO

import numpy as np
import torch

import rabit_tpu_torch
from rabit_tpu_torch.learn.data import SparseMat, load_libsvm
from rabit_tpu_torch.learn.lbfgs import LBFGSSolver, ObjFunction
from rabit_tpu_torch.ops import MAX
from rabit_tpu_torch.utils.checks import check
from rabit_tpu_torch.utils.device import resolve_device

LOSS_LINEAR = 0
LOSS_LOGISTIC = 1

# on-disk param block: base_score, num_feature, loss_type and a reserved
# pad, fixed little-endian (the reference's layout)
_PARAM_FMT = "<fQi64x"


class LinearModel:
    """Weights and the param block.  ``weight`` has ``num_feature + 1``
    entries; the last is the bias."""

    def __init__(self) -> None:
        self.base_score = 0.5
        self.num_feature = 0
        self.loss_type = LOSS_LOGISTIC
        self.weight: np.ndarray | None = None

    def set_param(self, name: str, val: str) -> None:
        if name == "base_score":
            self.base_score = float(val)
        elif name == "num_feature":
            self.num_feature = int(val)
        elif name == "objective":
            if val == "linear":
                self.loss_type = LOSS_LINEAR
            elif val == "logistic":
                self.loss_type = LOSS_LOGISTIC
            else:
                check(False, "unknown objective type %s", val)

    def init_base_score(self) -> None:
        """Fold base_score through the logit once at init."""
        check(0.0 < self.base_score < 1.0,
              "base_score must be in (0,1) for logistic loss")
        self.base_score = -float(np.log(1.0 / self.base_score - 1.0))

    # -- inference ---------------------------------------------------------
    def margin(self, data: SparseMat, weight: np.ndarray | None = None
               ) -> np.ndarray:
        """float64 margins, one a row; features >= ``num_feature`` are
        ignored."""
        w = self.weight if weight is None else weight
        nf = self.num_feature
        rows = np.repeat(np.arange(data.num_row), np.diff(data.indptr))
        keep = data.findex < nf
        contrib = w[data.findex[keep]] * data.fvalue[keep]
        return (self.base_score + w[nf]) + np.bincount(
            rows[keep], weights=contrib, minlength=data.num_row)

    def predict(self, data: SparseMat) -> np.ndarray:
        m = self.margin(data)
        if self.loss_type == LOSS_LOGISTIC:
            return 1.0 / (1.0 + np.exp(-m))
        return m

    # -- model IO ----------------------------------------------------------
    def _save_stream(self, write) -> None:
        write(struct.pack(_PARAM_FMT, self.base_score, self.num_feature,
                          self.loss_type))
        write(np.asarray(self.weight, np.float32).tobytes())

    def _load_stream(self, read) -> None:
        hdr = read(struct.calcsize(_PARAM_FMT))
        self.base_score, self.num_feature, self.loss_type = struct.unpack(
            _PARAM_FMT, hdr)
        raw = read(4 * (self.num_feature + 1))
        self.weight = np.frombuffer(raw, np.float32).astype(np.float64)

    def save(self, fname: str, base64_: bool = False) -> None:
        """``binf`` + the raw stream, or ``bs64\\t`` + its base64 text and
        a newline (always for ``stdout``)."""
        use_stdout = fname == "stdout"
        fp: BinaryIO = sys.stdout.buffer if use_stdout else open(fname, "wb")
        try:
            if base64_ or use_stdout:
                parts: list[bytes] = []
                self._save_stream(parts.append)
                fp.write(b"bs64\t" + base64.b64encode(b"".join(parts))
                         + b"\n")
            else:
                fp.write(b"binf")
                self._save_stream(fp.write)
        finally:
            if not use_stdout:
                fp.close()

    def load(self, fname: str) -> None:
        with open(fname, "rb") as fp:
            header = fp.read(4)
            if header == b"bs64":
                fp.read(1)  # tab
                raw = base64.b64decode(b"".join(fp.read().split()))
                pos = [0]

                def read(n: int) -> bytes:
                    pos[0] += n
                    return raw[pos[0] - n:pos[0]]
                self._load_stream(read)
            elif header == b"binf":
                self._load_stream(fp.read)
            else:
                check(False, "invalid model file")


def margins(wpad: torch.Tensor, base: float, idx: torch.Tensor,
            val: torch.Tensor) -> torch.Tensor:
    """Row margins over ELL blocks: ``base`` plus the gathered weights
    times the values, summed over each row's slots.  ``wpad`` ends in a
    zero slot that every padding index points at."""
    gathered = wpad.index_select(0, idx.reshape(-1)).view(idx.shape)
    return base + (gathered * val).sum(dim=-1)


def eval_loss(loss_type: int, wpad, base, idx, val, labels, valid
              ) -> torch.Tensor:
    """The shard's summed loss (a 0-d float32 tensor on the device)."""
    m = margins(wpad, base, idx, val)
    if loss_type == LOSS_LOGISTIC:
        # stable -log p(y=1 | m)
        nlogprob = torch.where(m > 0.0, torch.log1p(torch.exp(-m)),
                               -m + torch.log1p(torch.exp(m)))
        loss = labels * nlogprob + (1.0 - labels) * (m + nlogprob)
    else:
        loss = 0.5 * (m - labels) ** 2
    return (loss * valid).sum()


def grad_loss(loss_type: int, wpad, base, idx, val, labels, valid):
    """The shard's gradient: ``(gw, gbias)``, ``gw`` one float32 entry a
    slot of ``wpad`` (an ``index_add_`` of value x residual), ``gbias``
    the residuals' 0-d sum."""
    m = margins(wpad, base, idx, val)
    pred = torch.sigmoid(m) if loss_type == LOSS_LOGISTIC else m
    g = (pred - labels) * valid                     # (nb, B)
    gw = torch.zeros_like(wpad).index_add_(
        0, idx.reshape(-1), (val * g.unsqueeze(-1)).reshape(-1))
    return gw, g.sum()


class LinearObjFunction(ObjFunction):
    """The solver-facing objective with the train/pred CLI's params."""

    def __init__(self) -> None:
        self.model = LinearModel()
        self.reg_L2 = 0.0
        self.task = "train"
        self.model_in = "NULL"
        self.model_out = "final.model"
        self.name_pred = "pred.txt"
        self.save_base64 = False
        self.row_block = 1024
        self.device: str | None = None      # None: the card
        self.lbfgs = LBFGSSolver(self)
        self.dtrain: SparseMat | None = None
        self._ell = None

    # ------------------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        self.model.set_param(name, val)
        self.lbfgs.set_param(name, val)
        if name == "num_feature":
            self.lbfgs.set_param("num_dim", str(int(val) + 1))
        elif name == "reg_L2":
            self.reg_L2 = float(val)
        elif name == "task":
            self.task = val
        elif name == "model_in":
            self.model_in = val
        elif name == "model_out":
            self.model_out = val
        elif name == "name_pred":
            self.name_pred = val
        elif name == "save_base64":
            self.save_base64 = bool(int(val))
        elif name == "row_block":
            self.row_block = int(val)
        elif name == "linear_device":
            check(val in ("cpu", "cuda"),
                  "linear_device must be cpu|cuda, got %r", val)
            self.device = val

    def load_data(self, fname: str) -> None:
        self.dtrain = load_libsvm(fname)

    # ------------------------------------------------------------------
    # ObjFunction contract
    def init_num_dim(self) -> int:
        if self.model_in == "NULL":
            ndim = int(rabit_tpu_torch.allreduce(
                np.array([self.dtrain.feat_dim], np.int64), MAX)[0])
            self.model.num_feature = max(ndim, self.model.num_feature)
        return self.model.num_feature + 1

    def init_model(self, weight: np.ndarray) -> None:
        if self.model_in == "NULL":
            weight[:] = 0.0
            if self.model.loss_type == LOSS_LOGISTIC:
                self.model.init_base_score()
        else:
            weight[:] = self.model.weight

    def save_state(self) -> object:
        return (self.model.base_score, self.model.num_feature,
                self.model.loss_type)

    def load_state(self, state: object) -> None:
        (self.model.base_score, self.model.num_feature,
         self.model.loss_type) = state

    def _ell_blocks(self):
        """``(idx, val, labels, valid)`` as (nb, row_block, nnz) and
        (nb, row_block) tensors on the device, staged at the first call
        and resident from then on.  Padding slots and every feature >=
        ``num_feature`` point at the zero slot ``num_feature + 1``."""
        if self._ell is None:
            dev = resolve_device(self.device, "linear")
            nf = self.model.num_feature
            idx, val, labels, valid = self.dtrain.to_ell(
                pad_index=nf + 1, row_block=self.row_block)
            idx = np.where(idx >= nf, nf + 1, idx).astype(np.int32)
            nb = idx.shape[0] // self.row_block
            self._ell = tuple(torch.from_numpy(a).to(dev) for a in (
                idx.reshape(nb, self.row_block, -1),
                val.reshape(nb, self.row_block, -1),
                labels.reshape(nb, self.row_block),
                valid.reshape(nb, self.row_block)))
        return self._ell

    def _wpad(self, weight: np.ndarray, device) -> torch.Tensor:
        # [w_0..w_{nf-1}, bias, 0-pad] in float32
        return torch.from_numpy(np.concatenate(
            [weight, [0.0]]).astype(np.float32)).to(device)

    def eval(self, weight: np.ndarray) -> float:
        """The shard's data loss, plus the L2 term on rank 0 only (so it
        is added once globally)."""
        idx, val, labels, valid = self._ell_blocks()
        nf = self.model.num_feature
        base = float(np.float32(self.model.base_score + weight[nf]))
        sum_val = float(eval_loss(self.model.loss_type,
                                  self._wpad(weight, idx.device), base, idx,
                                  val, labels, valid))
        if rabit_tpu_torch.get_rank() == 0 and self.reg_L2 != 0.0:
            sum_val += 0.5 * self.reg_L2 * float(weight[:nf] @ weight[:nf])
        check(not np.isnan(sum_val), "nan occurs")
        return sum_val

    def calc_grad(self, weight: np.ndarray) -> np.ndarray:
        """The shard's gradient (float64), the L2 term on rank 0 only."""
        idx, val, labels, valid = self._ell_blocks()
        nf = self.model.num_feature
        base = float(np.float32(self.model.base_score + weight[nf]))
        gw, gbias = grad_loss(self.model.loss_type,
                              self._wpad(weight, idx.device), base, idx,
                              val, labels, valid)
        out = gw.cpu().numpy().astype(np.float64)[:nf + 1]
        out[nf] = float(gbias)
        if rabit_tpu_torch.get_rank() == 0 and self.reg_L2 != 0.0:
            out[:nf] += self.reg_L2 * weight[:nf]
        return out

    # ------------------------------------------------------------------
    def run(self) -> None:
        """``task=train`` (rank 0 saves the model) or ``task=pred``."""
        if self.model_in != "NULL":
            self.model.load(self.model_in)
        if self.task == "train":
            self.lbfgs.run()
            w = self.lbfgs.get_weight()
            self.model.weight = np.asarray(w, np.float64)
            if rabit_tpu_torch.get_rank() == 0:
                self.model.save(self.model_out, self.save_base64)
        elif self.task == "pred":
            check(self.model_in != "NULL",
                  "must set model_in for task=pred")
            preds = self.predict()
            with open(self.name_pred, "w") as fp:
                for p in preds:
                    fp.write(f"{p:g}\n")
            print(f"Finishing writing to {self.name_pred}", flush=True)
        else:
            check(False, "unknown task=%s", self.task)

    def predict(self) -> np.ndarray:
        return self.model.predict(self.dtrain)


def main(argv: list[str]) -> int:
    """CLI: ``linear <data_in> [name=value ...]``: the objective's params
    (``objective``, ``reg_L1``, ``reg_L2``, ``task``, ``model_in``,
    ``model_out``, ``linear_device=cpu|cuda``, the solver's) and the
    engine's, all in one list."""
    if len(argv) < 2:
        rabit_tpu_torch.init()
        if rabit_tpu_torch.get_rank() == 0:
            rabit_tpu_torch.tracker_print("Usage: <data_in> param=val")
        rabit_tpu_torch.finalize()
        return 0
    obj = LinearObjFunction()
    if argv[1] == "stdin":
        obj.load_data(argv[1])
        rabit_tpu_torch.init(argv[2:])
    else:
        rabit_tpu_torch.init(argv[2:])
        obj.load_data(argv[1])
    for a in argv[2:]:
        if "=" in a:
            name, val = a.split("=", 1)
            obj.set_param(name, val)
    obj.run()
    rabit_tpu_torch.finalize()
    return 0


def cli() -> int:
    """Console-script entry point."""
    return main(sys.argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
