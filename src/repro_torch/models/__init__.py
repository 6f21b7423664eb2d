"""The LM stack's models (port of ``repro/models`` for the attention
families): ``schema`` (parameter definitions, init, carrying the
reference's parameters across), ``layers``, ``model`` (schema, forward,
``LanguageModel``) and ``decode`` (KV cache and the one-token step)."""
