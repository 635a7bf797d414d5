"""The port's whole-model calibration PTQ against the JAX reference on the
CPU, the smoke LLaMA-3.2-3B's and Mixtral's cases: every leaf of the PTQ
tree under GPTQ, AWQ, SmoothQuant, OmniQuant and the LLaMA-3 recipe, and
the calibrated logits. ``tests/test_torch_calib_model.py`` holds the
smoke LLaMA-2-7B's cases, the capture, the conversion and the act_quant
launches, and states the tolerances; the shared fixtures are in
``tests/torch_calib_model_common.py``. The two files split one set of
cases by arch, so that under ``--dist loadfile`` each runs on its own
worker.
"""
import pytest

from torch_calib_model_common import (ALGO_RECIPES, check_calibrated_logits,
                                      check_ptq_tree,
                                      one_blas_thread)  # noqa: F401

ARCHS = ("llama3.2-3b", "mixtral-8x7b")


@pytest.mark.parametrize("name", [*ALGO_RECIPES, "llama3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_tree_equals_reference_leaf_for_leaf(arch, name):
    """Whole-model PTQ from the same captured rows: every leaf equal to the
    reference's (rot as bf16 bits). Seeds: block l's linears rotate by
    seed l; on Mixtral expert e of block l by seed l * E + e, and expert
    stacks get no calibration rows (RTN under the four algorithms)."""
    check_ptq_tree(arch, name)


@pytest.mark.parametrize("name", [*ALGO_RECIPES, "llama3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrated_logits_match_reference(arch, name):
    """The port's own PTQ (its capture of the calibration batch, then its
    algorithms) serves logits within 2e-2 of the largest logit of the
    reference's PTQ (its own capture)."""
    check_calibrated_logits(arch, name)
