import warnings

import pytest

warnings.filterwarnings("ignore", category=RuntimeWarning)


def pytest_configure(config):
    # donation is best-effort by design in the emulator (see
    # emulator._build_runner); pytest's warning capture overrides the
    # module-level filter installed there, so re-add it here
    config.addinivalue_line(
        "filterwarnings",
        "ignore:Some donated buffers were not usable")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skipped without one)")


def tiny_cfg(name, **over):
    from repro.configs import get_config
    cfg = get_config(name)
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=512, head_dim=16)
    base.update(over)
    return cfg.scaled(**base)


@pytest.fixture
def rng():
    import jax
    return jax.random.PRNGKey(0)
