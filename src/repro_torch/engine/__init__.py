"""The port's engine plane: so far only device resolution and tile rules
(``backend.py``). The measured tuner and plan cache are not ported yet;
``core.protocol.plan_for`` is the heuristic."""
