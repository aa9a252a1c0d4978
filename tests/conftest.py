"""Test config: run JAX on CPU with 8 virtual devices and f64 enabled.

Mirrors the reference's test strategy (SURVEY.md section 4): CPU-backend JAX
tests on toy fixtures; dense host kernels as oracle for device kernels;
virtual 8-device mesh for sharding tests.  Tests that need an NVIDIA GPU
carry the ``gpu`` marker and take the ``gpu`` fixture, which skips them where
there is no card; they run their device work in a child process, since this
process is held to the CPU.
"""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips where there is none)"
    )


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU answers nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
        [smi, "-L"], capture_output=True
    ).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
