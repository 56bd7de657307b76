"""Test programs run under the launcher (counterpart of kungfu_tpu.testing):
`fake_adaptive_trainer`, the elastic resize and heal replay without a
model.  The JAX package's FakeTrainerProgram, fake_trainer and bad_worker
size their fake models from the model zoo's (models/fakemodel.py) and
wait for ROADMAP A.7, with the pod harness; interference_worker waits for
A.8's detector."""

_LATER = ("FakeTrainerProgram",)


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(f"kungfu_tpu_torch.testing.{name} needs the fake model sizes "
                                  "of models/fakemodel.py, not ported yet (ROADMAP A.7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
