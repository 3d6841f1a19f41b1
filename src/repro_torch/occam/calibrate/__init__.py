"""``occam.calibrate`` — measured serving time.

:mod:`~repro_torch.occam.calibrate.timers` holds the tick timer that
serving sessions record. Fitting a cost model from measured stage times
is the calibration slice of the port.
"""
from .timers import TickTimers

__all__ = ["TickTimers"]
