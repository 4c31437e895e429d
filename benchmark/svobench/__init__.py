"""The benchmark of the stereo SVO port: its traffic generator, renderer,
drivers, trace reduction, peaks and the comparison that decides
``correct``. Imports the program (``stereo_svo_tpu_torch``) only in the
drivers (``benchmark/modes``), never JAX or the JAX package."""
