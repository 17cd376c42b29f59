"""mpc_cbf_tpu — a batched multi-agent MPC-CBF framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference C++
stack ``ywang760/mpc-cbf`` (Eigen + GiNaC symbolics + CPLEX), redesigned
to solve thousands of robots' QPs in lockstep on one accelerator:

- GiNaC symbolic Lie derivatives  -> JAX autodiff CBF engine (:mod:`.ops.cbf`)
- CPLEX QP solver                 -> batched interior-point and ADMM
  solvers (:mod:`.ops.qp`)
- Eigen linear algebra            -> precomputed static operators
  (:mod:`.ops.bernstein`, :mod:`.models.double_integrator`)
- sequential per-robot loops      -> vmapped agent axis
- bash-level scenario scale-out   -> sharded scenario axis over a device mesh
  (:mod:`.parallel`)

Layer map (mirrors reference layers L0-L7, see SURVEY.md §1):

=====  ==============================  =============================
Layer  Reference                       Here
=====  ==============================  =============================
L0     math/, common/                  ops/geometry.py, utils/
L1     qpcpp + CPLEX                   ops/qp/ (batched IPM, ADMM)
L2     cbf/detail, splines, model      ops/cbf.py, ops/bernstein.py,
                                       models/double_integrator.py
L3/L4  *QPOperations/*QPGenerator      controllers/*_assembly
L5     controllers                     controllers/
L6     examples mains                  parallel/sim.py
L7     experiments harness             utils/metrics.py, bench.py
=====  ==============================  =============================
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# At JAX's 'default' precision an f32 matmul may run in reduced precision:
# on the GPU as TF32 (about three decimal digits), enough to corrupt QP
# cost vectors by ~0.3% and stall the solvers. Batched products take that
# path while unbatched GEMVs may not, so the error appears only under
# vmap. A control stack needs real f32 linear algebra, so the package
# defaults matmul precision to 'highest' (full f32). The solvers also pin
# their own precision locally, so they stay correct even if an embedding
# application overrides this global.
# Override with MPC_CBF_TPU_MATMUL_PRECISION=default|high|highest.
_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("MPC_CBF_TPU_MATMUL_PRECISION", "highest"),
)

from mpc_cbf_tpu import models, ops, controllers, parallel, utils  # noqa: F401
