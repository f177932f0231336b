from iifea_tpu_torch.solvers.krylov import cg, bicgstab, gmres, gcr  # noqa: F401
from iifea_tpu_torch.solvers.direct import solve_direct  # noqa: F401
from iifea_tpu_torch.solvers.ksp import solve_ksp  # noqa: F401
from iifea_tpu_torch.solvers.newton import (  # noqa: F401
    NonlinearSolveError,
    solve_newtons_linear,
    solve_nonlinear,
)
from iifea_tpu_torch.solvers.trim import trim_mask_from_diag, apply_trim_rhs  # noqa: F401
from iifea_tpu_torch.solvers.condition import estimate_condition_number  # noqa: F401
from iifea_tpu_torch.solvers.lattice_fast import BinnedLatticeSolver  # noqa: F401
