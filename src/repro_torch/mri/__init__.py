"""repro_torch.mri — multi-coil MRI reconstruction on the planned FFT stack.

Port of ``repro.mri``, the source paper's headline application (medical
image processing), end to end: the SENSE encoding operators, reproducible
Cartesian undersampling, ESPIRiT-lite sensitivity estimation, iterative
CG-SENSE reconstruction, and Batchelor's motion-compensated forward model
built from the registration machinery.

Everything transforms through ``repro_torch.xfft`` → ``repro_torch.plan``:
a CG recon's inner loop is tens of planned centered transforms over two
problem keys, and on the card each is the fused CUDA kernels over the
whole coil stack. Under ``xfft.config(precision="double")`` the same calls
run at complex128 on the ``reference_x64`` engine.

* :mod:`repro_torch.mri.operators` — ``sense_forward`` / ``sense_adjoint``
  (a true adjoint pair under the ortho centered transform),
  ``apply_mask``, root-sum-of-squares ``rss_combine``; coil/frame axes
  batch through one planned transform.
* :mod:`repro_torch.mri.masks` — seeded ``uniform_mask`` /
  ``variable_density_mask`` (fully-sampled calibration block), realised
  ``acceleration``, and ``estimate_sensitivities`` (ESPIRiT-lite:
  windowed calibration ifft + RSS normalisation).
* :mod:`repro_torch.mri.recon` — ``recon_cg_sense`` (CG on the normal
  equations, optional Tikhonov ``lam``, per-iteration ``mri.cg.iter``
  residual events), the ``recon_zero_filled`` baseline, the shared
  ``cg_normal`` solver, and the ``nrmse`` gate metric.
* :mod:`repro_torch.mri.moco` — ``moco_forward`` / ``moco_adjoint``
  (per-shot masks × per-shot ``apply_shift``), ``recon_cg_moco``, shot
  partitioning and registration-based ``estimate_shot_shifts``.
* :mod:`repro_torch.mri.phantom` — the deterministic Shepp-Logan +
  birdcage-coil fixture (numpy).

Entry points run where the tensors lie; numpy or Python input with no
tensor beside it goes to ``torch.device("cuda")``.
"""

from repro_torch.mri.masks import (
    acceleration,
    estimate_sensitivities,
    uniform_mask,
    variable_density_mask,
)
from repro_torch.mri.moco import (
    estimate_shot_shifts,
    moco_adjoint,
    moco_forward,
    recon_cg_moco,
    shot_masks,
)
from repro_torch.mri.operators import (
    apply_mask,
    rss_combine,
    sense_adjoint,
    sense_forward,
)
from repro_torch.mri.phantom import birdcage_maps, shepp_logan
from repro_torch.mri.recon import (
    cg_normal,
    nrmse,
    recon_cg_sense,
    recon_zero_filled,
)

__all__ = [
    "acceleration",
    "apply_mask",
    "birdcage_maps",
    "cg_normal",
    "estimate_sensitivities",
    "estimate_shot_shifts",
    "moco_adjoint",
    "moco_forward",
    "nrmse",
    "recon_cg_moco",
    "recon_cg_sense",
    "recon_zero_filled",
    "rss_combine",
    "sense_adjoint",
    "sense_forward",
    "shepp_logan",
    "shot_masks",
    "uniform_mask",
    "variable_density_mask",
]
