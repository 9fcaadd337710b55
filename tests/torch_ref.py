"""How the port's tests build the reference's engines and workers.

Every ``rabit_tpu`` engine that a ``tests/test_torch_*.py`` file starts,
on a thread or in a launched process, runs the reference's numpy wire
path (``rabit_codec_impl=numpy``).  Left at ``auto``, the reference
resolves its compiled codec library, and when that library is not
built it logs a fallback warning through a logger that has no
``warning`` method, so the first reference engine of each process
raises ``AttributeError`` and its peers wait out their join deadline.
The port has no codec (ROADMAP A8) and moves the numpy wire's bytes,
so this is exactly the path it is held against.

Port engines never get the knob: the port refuses every
``rabit_codec_*`` setting by name.
"""

# The setting, as engine params and as a launched reference worker's
# environment.
REF_PARAMS = {"rabit_codec_impl": "numpy"}
REF_ENV = {"RABIT_CODEC_IMPL": "numpy"}


def ref_engine(cls):
    """A subclass of the reference engine ``cls`` whose ``init`` adds
    :data:`REF_PARAMS` (unless the caller chose a codec path);
    everything else is ``cls``'s."""
    class RefEngine(cls):
        def init(self, params):
            super().init({**REF_PARAMS, **params})

    RefEngine.__name__ = cls.__name__
    RefEngine.__qualname__ = cls.__qualname__
    return RefEngine
