"""Analysis helpers of the port (``repro/analysis``): the bandwidth roof
the engine reads (``roofline.py``) and a trace of where a served batch's
time goes (``serve_trace.py``, ``python -m
repro_torch.analysis.serve_trace``)."""
