"""The low-precision steps of the UNets (2-D and 1-D), the 1-D NIOs and the 3-D NIO
against JAX's on the CPU: :func:`test_torch_amp.check_step`, whose note says what is held
and why, on the families that ``tests/test_torch_amp.py`` leaves to this file."""
import pytest

from test_torch_amp import NIO_2D, FAMILIES, check_step, one_thread_no_onednn, step_cases  # noqa: F401


@pytest.mark.parametrize("name,dtype,policy",
                         step_cases([n for n in FAMILIES if n not in NIO_2D]))
def test_low_precision_step_matches_jax(name, dtype, policy, monkeypatch):
    check_step(name, dtype, policy, monkeypatch)
