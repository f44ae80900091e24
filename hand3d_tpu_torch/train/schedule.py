"""Learning-rate schedules (counterpart of hand3d_tpu/train/schedule.py)."""


def piecewise_constant(steps, values):
    """Multi-step LR schedule: values[i] while step < steps[i].

    The reference's utils/general.LearningRateScheduler (:480-519), stepped
    correctly (its training scripts never passed global_step to
    opt.minimize, so they trained at values[0] throughout).

    Args:
      steps: increasing step boundaries (len n - 1).
      values: LR values (len n).
    Returns:
      schedule(step) -> lr, a Python float for a Python int step.
    """
    if len(steps) + 1 != len(values):
        raise ValueError("need one more value than steps")
    bounds = [int(b) for b in steps]
    vals = [float(v) for v in values]

    def schedule(step):
        return vals[sum(int(step) >= b for b in bounds)]

    return schedule
