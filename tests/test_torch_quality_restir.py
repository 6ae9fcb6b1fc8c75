"""PyTorch port, the converged-truth quality gate on the CPU, the Cornell
ReSTIR configs: BASELINE configs 4 (no denoise) and 5 (the full
pipeline) at 128x72 against their converged truths under the ledger's
bounds (tests/test_torch_quality.py has configs 1 and 3 and the bars).
"""

import pytest

import torch_parity  # noqa: F401  (one torch thread a worker)
from torch_quality_cases import check_case


@pytest.mark.parametrize("name", ["4_progressive_64f_1080p",
                                  "5_full_pipeline"])
def test_quality_vs_converged_truth(name):
    check_case(name)
