"""Learning apps on the port's API (counterpart of :mod:`rabit_tpu.learn`).
Ported so far: k-means, gradient-boosted trees with their histogram
builders, and the data utilities."""
from rabit_tpu_torch.learn import boosting, histogram, kmeans
from rabit_tpu_torch.learn.data import SparseMat, load_libsvm, save_matrix_txt

__all__ = ["SparseMat", "load_libsvm", "save_matrix_txt", "kmeans",
           "boosting", "histogram"]
