"""The port's data pipeline (`repro_torch.data`) against the reference's
(`repro.data`): the same (seed, step) gives the same batch, element for
element, for every corpus, with one codebook and with four."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.data import (ArithGenerator as JArith, DataConfig as JDataConfig,  # noqa: E402
                        data_iterator as jdata_iterator,
                        make_generator as jmake_generator)
from repro_torch.data import (ArithGenerator, DataConfig, data_iterator,  # noqa: E402
                              make_generator)


@pytest.mark.parametrize("codebooks", [1, 4])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["markov", "arith", "copy"])
def test_batches_equal_the_reference(kind, seed, codebooks):
    kw = dict(vocab_size=64, seq_len=32, batch_size=4, kind=kind, seed=seed,
              n_codebooks=codebooks)
    ref = jmake_generator(JDataConfig(**kw))
    port = make_generator(DataConfig(**kw), device="cpu")
    for step in (0, 5):
        want, got = ref.batch(step), port.batch(step)
        assert set(got) == {"tokens", "labels"}
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        shape = (4, 32) + ((codebooks,) if codebooks > 1 else ())
        assert tuple(got["tokens"].shape) == shape


def test_iterator_starts_at_its_step():
    kw = dict(vocab_size=64, seq_len=16, batch_size=2, seed=1)
    ref = jdata_iterator(JDataConfig(**kw), start_step=3)
    port = data_iterator(DataConfig(**kw), start_step=3, device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(next(port)["tokens"].numpy(),
                                      np.asarray(next(ref)["tokens"]))


@pytest.mark.parametrize("digits", [1, 2])
def test_arith_prompts_and_verify_equal_the_reference(digits):
    kw = dict(vocab_size=16, seq_len=32, batch_size=2, kind="arith")
    ref, port = (JArith(JDataConfig(**kw), digits=digits),
                 ArithGenerator(DataConfig(**kw), digits=digits))
    assert (port.base, port.mod, port.PLUS, port.EQ, port.SEP) == \
        (ref.base, ref.mod, ref.PLUS, ref.EQ, ref.SEP)
    for seed in range(20):
        rp, ra = ref.make_prompt(np.random.default_rng(seed))
        pp, pa = port.make_prompt(np.random.default_rng(seed))
        np.testing.assert_array_equal(pp, rp)
        assert pa == ra
        good = np.array(port._digits_of(pa), np.int32)
        for completion in (good, (good + 1) % port.base, good[:digits - 1]):
            assert port.verify(completion, pa) == ref.verify(completion, ra)
        assert port.verify(good, pa)


def test_batches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gen = make_generator(DataConfig(vocab_size=64, seq_len=8, batch_size=2))
    # prompts need no device; a batch does
    assert gen.cfg.kind == "markov"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen.batch(0)
