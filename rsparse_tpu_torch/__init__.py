"""rsparse_tpu_torch: the PyTorch + CUDA (Hopper) port of rsparse_tpu.

It covers single-device WRMF (implicit and explicit feedback, the CG,
Cholesky and NNLS solvers, user/item and global biases, dynamic lambda and
the dense zipf head), the low-rank family (soft_svd / soft_impute,
PureSVD, LinearFlow, ScaleNormalize, SparsePlusLowRank input, kmeans),
with fitting, ``transform`` and masked top-k ``predict``, the SGD models
FTRL, FactorizationMachine and RankMF, and GloVe; the host side around
them: interaction logs read into CSR (``data.io.load_interactions``),
checkpoints in the JAX package's format (``checkpoint.save`` / ``load``,
and WRMF's mid-fit state with ``resume``), a ``torch.profiler`` trace
(``utils.profiling.trace``) and the command line (``python -m
rsparse_tpu_torch fit|recommend``, ``cli.py``).  Its kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc`` at
first use; on CPU tensors every wrapper runs its plain PyTorch version.
Entry points run on "cuda" unless given ``device="cpu"``.

The reference's Gram matrices and exact solves run at full float32, so
TF32 matmuls are switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .config import logger, resolve_dtype  # noqa: E402,F401
from .data.movielens import load_movielens100k  # noqa: E402,F401
from .models.base import MatrixFactorizationRecommender, TopK  # noqa: E402,F401,E501
from .models.fm import FactorizationMachine  # noqa: E402,F401
from .models.ftrl import FTRL  # noqa: E402,F401
from .models.glove import GloVe  # noqa: E402,F401
from .models.kmeans import kmeans  # noqa: E402,F401
from .models.linear_flow import LinearFlow  # noqa: E402,F401
from .models.pure_svd import PureSVD  # noqa: E402,F401
from .models.rankmf import RankMF  # noqa: E402,F401
from .models.scale_normalize import ScaleNormalize  # noqa: E402,F401
from .models.soft_als import (SVDResult, soft_als, soft_impute,  # noqa: E402,F401,E501
                              soft_svd)
from .models.wrmf import WRMF  # noqa: E402,F401
from .ops.topk import top_product  # noqa: E402,F401
from .sparse.splr import SparsePlusLowRank  # noqa: E402,F401
from .utils.metrics import ap_k, ndcg_k  # noqa: E402,F401
from .utils.split import train_test_split  # noqa: E402,F401
from .utils import checkpoint  # noqa: E402,F401
