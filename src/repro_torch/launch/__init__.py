"""Device groups of the port (``launch/mesh.py``), the training launcher
(``launch/train.py``), the meta-device dry run of every (arch x shape)
cell (``launch/dryrun.py``) and its tables (``launch/report.py``)."""
