"""Learning apps on the port's API (counterpart of :mod:`rabit_tpu.learn`).
Ported: k-means, gradient-boosted trees with their histogram builders,
linear and logistic regression on the vector-free L-BFGS solver, and the
data utilities."""
from rabit_tpu_torch.learn.data import SparseMat, load_libsvm, save_matrix_txt
from rabit_tpu_torch.learn.lbfgs import LBFGSSolver, ObjFunction
from rabit_tpu_torch.learn.linear import LinearModel, LinearObjFunction
from rabit_tpu_torch.learn import boosting, histogram, kmeans

__all__ = ["SparseMat", "load_libsvm", "save_matrix_txt",
           "LBFGSSolver", "ObjFunction",
           "LinearModel", "LinearObjFunction",
           "boosting", "histogram", "kmeans"]
