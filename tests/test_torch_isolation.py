"""The port stands alone: no JAX, no reference package, no library kernel.

``repro_torch``, ``chip_smoke.py`` and ``examples/torch`` import neither
``jax`` nor ``repro``;
the package calls neither ``torch.fft``, ``scaled_dot_product_attention``
nor ``torch.compile`` (the smoke script may time the first two as its
yardsticks); and non-tensor input is sent to the card, so it raises where
CUDA is absent.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
IMPORTS_REFERENCE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
LIBRARY_CALLS = re.compile(r"torch\.(fft|compile)\b|from\s+torch\s+import\s+(fft|compile)\b"
                           r"|scaled_dot_product_attention")


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys; import repro_torch; import repro_torch.xfft; "
        "import repro_torch.kernels.ops; import repro_torch.kernels.butterfly; "
        "import repro_torch.kernels.flash_attention; "
        "import repro_torch.kernels.slstm_scan; "
        "import repro_torch.core.spectral; import repro_torch.imaging; "
        "import repro_torch.obs; import repro_torch.mri; import repro_torch.engines.x64; "
        "import repro_torch.resilience; import repro_torch.serve; "
        "import repro_torch.serve.queue, repro_torch.serve.loop, repro_torch.serve.engine; "
        "import repro_torch.serve.imaging, repro_torch.serve.wisdom; "
        "import repro_torch.xfft._report; from repro_torch.xfft import report, report_data; "
        "import repro_torch.compat, repro_torch.core.distributed, repro_torch.checkpoint; "
        "import repro_torch.models.config, repro_torch.models.param, repro_torch.models.layers; "
        "import repro_torch.models.attention, repro_torch.models.transformer; "
        "import repro_torch.models.build, repro_torch.configs, repro_torch.data; "
        "import repro_torch.launch.serve; from repro_torch.serve import ServeEngine, Request; "
        "import repro_torch.optim, repro_torch.optim.compression, repro_torch.train; "
        "import repro_torch.train.loop, repro_torch.launch.train; "
        "import repro_torch.launch.dryrun, repro_torch.launch.report; "
        "import repro_torch.launch.hlo_cost, repro_torch.launch.hlo_analysis; "
        "from repro_torch.configs import get_config; get_config('llama3.2-3b'); "
        "bad = [m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'repro.'))]; print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples" / "torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_reference(path):
    text = path.read_text()
    assert not IMPORTS_REFERENCE.search(text)
    if path.name != "chip_smoke.py":
        assert not LIBRARY_CALLS.search(text)
    else:
        assert "torch.compile" not in text


def test_numpy_input_goes_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    from repro_torch import xfft

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfft.fft2(np.zeros((4, 8, 8), np.complex64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfft.rfft([1.0, 2.0, 3.0, 4.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xfft.fftfreq(8)
