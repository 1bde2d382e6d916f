"""The examples, ported: ``python -m repro_torch.examples.<name>`` with
``quickstart``, ``serve_lm``, ``train_lm`` and ``vector_unit_demo``; each
runs on the card unless ``--device cpu`` is given."""
