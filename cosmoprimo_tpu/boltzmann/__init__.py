"""Native Boltzmann machinery: recombination thermodynamics and linear
perturbations, fully traced JAX (jit/vmap/jacfwd-clean).

The reference (cosmodesi/cosmoprimo) obtains every quantity in this
subpackage from external C codes (CLASS via pyclass, CAMB); this subpackage
computes them natively on device, so a linear power spectrum requires no
host round-trip and differentiates end-to-end. Validation anchors are the
CLASS v3.1.1 outputs archived by the reference
(/root/reference/cosmoprimo/tests/fiducial/abacus_cosm000_*) and the CLASS
rs_drag of the DESI fiducial (reference bao_filter.py:166).
"""

from .thermodynamics import ThermodynamicsResult, compute_thermodynamics

__all__ = ['ThermodynamicsResult', 'compute_thermodynamics']
