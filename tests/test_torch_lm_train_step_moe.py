"""Port parity for the LM train step on the moe and recurrent
configurations: one fp32 step of repro_torch.train.steps against
repro.train.steps at ``reduce()``, at the bars and with the helpers of
tests/test_torch_lm_train_step.py (the routing recorded in both packages,
no token's experts differing)."""
import pytest

from repro.configs.all import ASSIGNED
from repro.configs.base import get_config as jget_config

from test_torch_lm_train_step import one_step_matches_reference

MOE_AND_RECURRENT = [n for n in ASSIGNED
                     if jget_config(n).family in ("moe", "hybrid", "ssm")]


@pytest.mark.parametrize("name", MOE_AND_RECURRENT)
def test_one_step_matches_reference_fp32(name, monkeypatch):
    one_step_matches_reference(name, monkeypatch)
