"""Data-parallel exploration steps of P2E-DV2 and P2E-DV1 on the CPU, as
tests/test_torch_dp_dreamer_steps.py holds DreamerV2's and DreamerV1's: one
gradient step of the port on two gloo ranks against the JAX package's step
on a two-device mesh and against the port's one-process step (seeded
draws), from the same weights and a batch of B = 4, within the tolerances
of tests/test_torch_p2e_dv2.py and test_torch_p2e_dv1.py (the metrics rtol
1e-4 + atol 1e-5, every trained module's parameters by their change within
1e-3 of its norm, the target critics left exactly where the JAX step left
them); the two ranks hold the same parameters bit for bit.
"""

import os

import pytest
import torch
import test_torch_dp_dreamer_steps as dreamer_steps

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["p2e_dv2", "p2e_dv1"])
def test_two_ranks_match_the_jax_two_device_step_and_the_one_process_step(family, monkeypatch, tmp_path):
    dreamer_steps.check_family(family, monkeypatch, tmp_path)
