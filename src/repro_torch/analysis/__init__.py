"""Analysis helpers of the port (``repro/analysis``): the three-term
roofline at the H100's data-sheet constants, the bandwidth roof the engine
reads and the six kernels' bounds (``roofline.py``), the op-level cost
counter of a step run on the meta device (``op_cost.py``, the counterpart
of the reference's ``hlo_cost.py``), and a trace of where a served batch's
time goes (``serve_trace.py``, ``python -m
repro_torch.analysis.serve_trace``)."""
