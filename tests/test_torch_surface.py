"""The port's package surface against the JAX package's: every public name
of parakeet_tpu is exported by parakeet_tpu_torch or on the port's explicit
list of names not ported, and that list holds nothing else."""

import pytest

import parakeet_tpu as R
import parakeet_tpu_torch as T


def test_every_reference_name_is_exported_or_listed():
    missing = sorted(set(R.__all__) - set(T.__all__))
    assert missing == sorted(T.NOT_PORTED)
    assert not set(T.NOT_PORTED) & set(T.__all__)
    assert len(set(T.NOT_PORTED)) == len(T.NOT_PORTED) == 4


@pytest.mark.parametrize("name", sorted(set(R.__all__) - set(T.NOT_PORTED)))
def test_exported_name_resolves(name):
    assert name in T.__all__
    assert getattr(T, name) is not None
    # a class or function keeps the reference's name (no alias of another)
    ref = getattr(R, name)
    if hasattr(ref, "__name__"):
        assert getattr(T, name).__name__ == ref.__name__


def test_all_is_exact():
    assert len(T.__all__) == len(set(T.__all__))
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.__version__ == R.__version__


def test_mesh_training_surface_matches_reference():
    """The mesh-training names (parallel/, train.make_sharded_trainer,
    train_loop, checkpoint): the reference's exports, each with the
    reference's parameters in its order (the port adds only `device`)."""
    import inspect

    import parakeet_tpu.parallel as RPAR
    import parakeet_tpu_torch.parallel as TPAR
    from parakeet_tpu import checkpoint as RCK
    from parakeet_tpu import train as RT
    from parakeet_tpu import train_loop as RL
    from parakeet_tpu.parallel import pipeline as RPP
    from parakeet_tpu_torch import checkpoint as TCK
    from parakeet_tpu_torch import train as TT
    from parakeet_tpu_torch import train_loop as TL
    from parakeet_tpu_torch.parallel import pipeline as TPP

    assert TPAR.__all__ == RPAR.__all__
    for name in RPAR.__all__:
        assert getattr(TPAR, name).__name__ == getattr(RPAR, name).__name__
    assert set(RPP.__all__) <= set(TPP.__all__)
    assert set(RL.__all__) <= set(TL.__all__) and set(RCK.__all__) <= set(TCK.__all__)
    for ref, port, name in ((RT, TT, "make_sharded_trainer"), (RPP, TPP, "make_pp_trainer"),
                            (RPP, TPP, "pipeline_encode"), (RPP, TPP, "split_layer_params"),
                            (RPP, TPP, "merge_layer_params"), (RL, TL, "run_training"),
                            (RL, TL, "place_train_state"), (RCK, TCK, "save_train_state"),
                            (RCK, TCK, "load_train_state")):
        want = list(inspect.signature(getattr(ref, name)).parameters)
        got = list(inspect.signature(getattr(port, name)).parameters)
        assert got[:len(want)] == want and set(got[len(want):]) <= {"device"}, name
