"""The multi-device parity checks of ``chip_smoke.py --four-cards`` on the
virtual 8-device CPU mesh: each sharded path against its single-device
result, at CPU-sized widths (kernels in the Pallas interpreter)."""

import jax
import pytest

from particle_sim_tpu.parallel import mesh as mesh_lib
from particle_sim_tpu.utils import parity

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform")


@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.make_mesh()


@pytest.mark.parametrize("substeps,use_kernel", [(1, False), (3, True)])
def test_mesh_attractor(mesh, substeps, use_kernel):
    r = parity.mesh_attractor(mesh, 8192, substeps, use_kernel=use_kernel,
                              interpret=use_kernel)
    assert r["ok"], r


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mesh_ring(mesh, use_kernel):
    r = parity.mesh_ring(mesh, 2048, use_kernel=use_kernel,
                         interpret=use_kernel)
    assert r["ok"], r


def test_mesh_pm(mesh):
    r = parity.mesh_pm(mesh, 8192, grid=32)
    assert r["ok"], r


def test_mesh_persist_pm(mesh):
    r = parity.mesh_persist_pm(mesh, 8192, grid=32)
    assert r["ok"], r


def test_mesh_render(mesh):
    r = parity.mesh_render(mesh, 8192, width=320, height=180)
    assert r["ok"], r
