"""Traffic generators, one module a kind.

A traffic file (``ssabench/traffic/<name>.json``) names its ``kind``; the
module ``ssabench/mixes/<kind>.py`` defines ``Mix(config, traffic, seed,
device)`` with ``warm()``, ``call(i) -> dict`` (the work of request ``i``:
``requests`` and the counts the end-to-end metrics read), ``answers``,
``stats``, ``release()`` and ``check(done, saturate=None)``.
"""
