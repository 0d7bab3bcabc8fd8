"""The port's command-line scripts: copies of the repository's
``scripts/cluster.py``, ``scripts/soak.py`` and ``scripts/obs_report.py``
over ``dag_rider_tpu_torch``, each run as ``python -m
dag_rider_tpu_torch.scripts.<name>``."""
