"""`utils/lane_probe.py` on the CPU: how it reads lp_substep (the phases
each K2 build runs, the `only_<phase>` variants that keep one phase and the
preprocessor's branches, and their host builds), and the stacked BoxStacking
scene it times and `chip_smoke.py` holds the two-box builds on (cube-cube
contact where the pick cube rests on the platform)."""

import pytest
import torch

from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.utils import lane_probe as lp
from dexrobot_isaac_tpu_torch.utils.config import load_config
from dexrobot_isaac_tpu_torch.utils.kernel_build import BUILDS, CSRC
from tests.proc import run

ONE_BOX = ["fk", "spheres", "forces", "body", "tree_store", "tree_level", "mass_row", "rhs",
           "ltl", "forward"]
# the two-cube build's contacts: pass A (spheres, forces, body_sums), then
# pass B over the same words (box2_forces, body)
TWO_BOX = ["fk", "spheres", "forces", "body_sums", "box2_forces", "body", "tree_store",
           "tree_level", "mass_row", "rhs", "ltl", "forward"]


@pytest.fixture(scope="module")
def variants():
    return lp._variants(CSRC)


@pytest.mark.parametrize("build,want", [("control_step", ONE_BOX),
                                        ("control_step_box2", TWO_BOX)])
def test_build_phases(variants, build, want):
    _, _, items = variants
    assert lp.build_phases(items, BUILDS[build][1]) == want


@pytest.mark.parametrize("variant", ["none", "only_fk", "only_body_sums", "only_box2_forces",
                                     "only_ltl"])
def test_variant_keeps_one_phase(variants, variant):
    """A variant's lp_substep holds its one phase (none: no phase) and every
    directive; the rest of the file is the source's."""
    src, out, items = variants
    text, orig = out[variant]["lane_physics.cuh"], src["lane_physics.cuh"]
    a, b, kept = lp.substep_items(text)
    a0, b0, _ = lp.substep_items(orig)
    assert [n for n, _ in kept if n != "#"] == ([] if variant == "none" else [variant[5:]])
    assert [t for n, t in kept if n == "#"] == [t for n, t in items if n == "#"]
    assert text[:a] == orig[:a0] and text[b:] == orig[b0:]


@pytest.mark.parametrize("variant,build", [("none", "control_step_box2"),
                                           ("only_box2_forces", "control_step_box2"),
                                           ("only_body_sums", "control_step"),
                                           ("only_forces", "control_step")])
def test_variant_compiles_for_the_host(variants, tmp_path, variant, build):
    """Each variant builds with the build's defines (g++, syntax only); in
    the one-box build a two-box phase leaves the substep empty."""
    src, out, _ = variants
    for f, text in src.items():
        (tmp_path / f).write_text(out[variant].get(f, text))
    run(["g++", "-x", "c++", "-fsyntax-only", "-std=c++17", *BUILDS[build][1],
         str(tmp_path / (BUILDS[build][0] + ".cu"))], timeout=300)


def test_stacked_scene_has_cube_cube_contact():
    """From a reset, a quarter of the envs (0 mod 4) rest their pick cube on
    the platform, interpenetrating: cube-cube contact there and nowhere else
    (the dropped cubes are still above their platforms)."""
    env = make_env(load_config(["task=BoxStacking", "numEnvs=8"]), seed=3, device="cpu")
    state, _ = env.reset_fn()
    ph = lp.stacked_scene(env, state, torch.Generator().manual_seed(4))
    assert bool((ph.box_pos[::4, 2] > ph.box2_pos[::4, 2]).all())
    assert lp.contact_counts(env.comps.engine, ph, state.dr)[0] == 2
