"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, each cell at a small size on the CPU,
once for each fault the cell can have."""

import pytest
import torch

from gpubench.tests.conftest import run_small, small_training, small_vo

TRAIN = "pilotnet-train-x3-b1024"


def checks(outcome):
    return {c.name: c for c in outcome.checks}


@pytest.fixture(scope="module")
def vo_sound():
    return run_small("vo-parallax-720p", small_vo(), 12)


def test_vo_extractor_sound(vo_sound):
    got = checks(vo_sound)
    assert got["keypoint_mismatches"].value == 0 and got["descriptor_bit_mismatches"].value == 0


def test_vo_answer_altered_where_produced(monkeypatch):
    """A descriptor bit flipped in the extractor's output."""
    from pilotguru_tpu_torch.vo import pipeline

    original = pipeline.extract_orb_features_batch

    def flipped(*args, **kwargs):
        kps = original(*args, **kwargs)
        desc = kps.descriptors.clone()
        desc[:, 0, 0] ^= 1
        return kps._replace(descriptors=desc)

    monkeypatch.setattr(pipeline, "extract_orb_features_batch", flipped)
    got = checks(run_small("vo-parallax-720p", small_vo(), 12))
    assert not got["descriptor_bit_mismatches"].ok


@pytest.mark.parametrize("name", [TRAIN, "pilotnet-search-x12-b1024"])
def test_training_sound(name):
    outcome = run_small(name, small_training(name), 3)
    assert all(c.ok for c in outcome.checks), outcome.checks


def broken_step(monkeypatch, fault):
    from pilotguru_tpu_torch.ml import training

    original = training.make_train_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def run(state, inputs, labels, weights, use_mask, generator, **kw):
            if fault == "half_batch":
                half = labels.shape[0] // 2
                inputs = {k: v[:half] for k, v in inputs.items()}
                return step(state, inputs, labels[:half], weights[:, :half], use_mask,
                            generator, **kw)
            _, losses, per_example = step(state, inputs, labels, weights, use_mask,
                                          generator, **kw)
            return state, losses, per_example

        return run

    monkeypatch.setattr(training, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_caught(monkeypatch, fault):
    broken_step(monkeypatch, fault)
    outcome = run_small(TRAIN, small_training(TRAIN), 3)
    assert not all(c.ok for c in outcome.checks), outcome.checks


def test_checks_use_plain_float32():
    assert not torch.backends.cuda.matmul.allow_tf32
