"""tensoralloy_tpu — a JAX framework for training
neural-network interatomic potentials for alloys and molecules.

Re-designed from scratch with the capabilities of Bismarrck/tensoralloy:
descriptor NNs (Behler symmetry functions, GRAP moment tensors,
temperature-dependent variants), physics-structured EAM/ADP potentials,
autodiff forces/stress/Hessian, physics-constraint losses, LAMMPS/native
export, an ASE-compatible calculator interface and analysis tooling.
"""

__version__ = "0.1.0"

from .atoms import Structure            # noqa: F401
from .precision import (precision_scope, set_precision,  # noqa: F401
                        get_float_dtype)
