"""The port against the reference-semantics emulator in kin + IMU mode (CPU).

The twin of tests/test_refemu_parity.py's kin-mode test, beside the IMU
twins of tests/test_torch_refemu.py (its configuration, sim and helpers),
in a file of its own: each takes minutes of one worker, and a test run
spreads files over its workers.
"""

import numpy as np

# First: test_torch_refemu puts tools/ (the emulator) on the path.
from test_torch_refemu import _cfg, _distances, _gt_ate, short_sim  # noqa: F401,I001
from legkilo_torch.runner import run_offline
from refemu.emulator import EmuParams, run_emulator
from torch_util import one_thread  # noqa: F401


def test_kin_mode_reference_semantics_parity(short_sim):
    """Kin + IMU mode: the emulator at the reference's semantics tracks GT,
    and the port agrees with it at the cm level."""
    cfg = _cfg(False)
    results = run_offline(cfg, short_sim.scans, short_sim.kin, device="cpu")
    emu = run_emulator(short_sim.scans, short_sim.kin, EmuParams.from_config(cfg))
    assert _gt_ate(short_sim, emu[0], emu[2]) < 0.05
    d = _distances(results, emu)
    assert np.sqrt((d ** 2).mean()) < 0.03
