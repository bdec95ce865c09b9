"""rsparse_tpu_torch: the PyTorch + CUDA (Hopper) port of rsparse_tpu.

It covers single-device WRMF: implicit and explicit feedback, the CG,
Cholesky and NNLS solvers, user/item and global biases, dynamic lambda and
the dense zipf head, with fitting, ``transform`` and masked top-k
``predict``.  Its four kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use; on CPU tensors every
wrapper runs its plain PyTorch version.

The reference's Gram matrices and exact solves run at full float32, so
TF32 matmuls are switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .config import logger, resolve_dtype  # noqa: E402,F401
from .data.movielens import load_movielens100k  # noqa: E402,F401
from .models.base import TopK  # noqa: E402,F401
from .models.wrmf import WRMF  # noqa: E402,F401
from .ops.topk import top_product  # noqa: E402,F401
from .utils.metrics import ap_k, ndcg_k  # noqa: E402,F401
from .utils.split import train_test_split  # noqa: E402,F401
