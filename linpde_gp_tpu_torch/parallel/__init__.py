"""Multi-rank scale-out on ``torch.distributed``: mesh-sharded Gram
assembly, distributed blocked Cholesky and solves, incremental Schur
extension, sharded posterior evaluation and the distributed gram-free
regressor (port of ``linpde_gp_tpu/parallel``).  Each rank is one process
with one device; ``launch.spawn`` starts a world of ranks on one machine,
``torchrun`` on several."""

from .mesh import Mesh, make_1d_mesh, make_mesh, replicated, row_sharding
from .gram import gather_gram, sharded_gram
from .cholesky import (
    BlockRows,
    distributed_chol_solve,
    distributed_cholesky,
    distributed_cholesky_2d,
    distributed_cholesky_cyclic,
    distributed_tri_solve,
)
from .extend import DistributedCholFactor
from .iterative import DistributedIterativeGPRegressor, distributed_gram_matvec
from .posterior import sharded_posterior_eval
from .solve import DistributedConditioner, distributed_condition

__all__ = [
    "Mesh",
    "make_mesh",
    "make_1d_mesh",
    "row_sharding",
    "replicated",
    "sharded_gram",
    "gather_gram",
    "BlockRows",
    "distributed_cholesky",
    "distributed_cholesky_2d",
    "distributed_cholesky_cyclic",
    "distributed_chol_solve",
    "distributed_tri_solve",
    "DistributedCholFactor",
    "DistributedIterativeGPRegressor",
    "distributed_gram_matvec",
    "sharded_posterior_eval",
    "distributed_condition",
    "DistributedConditioner",
]
