"""The LM stack's models (port of ``repro/models``): ``schema`` (parameter
definitions, init, carrying the reference's parameters across), ``layers``,
``moe``, ``mla``, ``ssm``, ``model`` (schema, forward, ``LanguageModel``)
and ``decode`` (the per-family caches and the one-token step)."""
