"""The control and the planted faults that a run's comparison has to catch,
each put in the place of a configuration's driver call."""

from __future__ import annotations

from portbench import spec


def control(config):
    """The plain reference one precision lower, in the program's place."""
    reference = spec.reference(config)
    return lambda frames, params: reference.reference(frames, params, control=True)


def altered_answer(config):
    """The port's outputs with one frame's small result changed where it is made."""
    driver = spec.driver(config)

    def call(frames, params):
        outs = dict(driver.call(frames, params))
        small = outs[driver.RESULT].clone()
        small.view(small.shape[0], -1)[0, 0] += 1
        outs[driver.RESULT] = small
        return outs

    return call


def half_batch(config):
    """The port run on the first half of a batch, its outputs standing in for
    the second half too."""
    driver = spec.driver(config)

    def call(frames, params):
        half = max(1, frames.shape[0] // 2)
        outs = driver.call(frames[:half].contiguous(), params)
        reps = -(-frames.shape[0] // half)
        return {k: None if v is None else v.repeat(reps, *([1] * (v.ndim - 1)))[:frames.shape[0]]
                for k, v in outs.items()}

    return call


def stale_batch(config):
    """The outputs of the previous batch served again (a cache that never misses)."""
    driver = spec.driver(config)
    last = {}

    def call(frames, params):
        outs = driver.call(frames, params)
        served = last.get("outs", outs)
        last["outs"] = outs
        return served

    return call


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch, "stale_batch": stale_batch}

