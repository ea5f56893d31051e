"""The repository's smoke tools on the port: ``training_smoke`` (the root
``test_training.py``), ``memory_smoke`` (``test_memory.py``) and
``check_config`` (``check_config.py``), run as
``python -m pixelnerf_tpu_torch.tools.<name>``."""
