"""__graft_entry__.dryrun_multichip runs on the ambient devices and says
which; it never falls back to a CPU mesh unless asked to."""

import jax
import pytest

import __graft_entry__ as g


def test_dryrun_runs_on_ambient_devices(capsys):
    g.dryrun_multichip(2)
    out = capsys.readouterr().out
    dev = jax.devices()[0]
    assert f"on 2 {dev.platform} devices" in out
    assert "virtual" not in out
    assert "ZeRO state sharding ok" in out


def test_dryrun_refuses_too_few_devices_without_asking():
    with pytest.raises(AssertionError, match="virtual_cpu=True"):
        g.dryrun_multichip(len(jax.devices()) + 1)
