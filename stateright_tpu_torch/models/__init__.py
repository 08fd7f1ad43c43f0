"""Models with tensor twins (``stateright_tpu/models/`` counterparts)."""
