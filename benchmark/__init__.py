"""The benchmark of ``manga_image_translator_tpu_torch``: see ``run.py``."""
