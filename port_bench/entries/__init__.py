"""The program's entry points that a traffic mix drives, one module each.

A mix file names its entry (``"entry": "<module>"``); the module's ``Entry``
class takes (configuration, mix, seed, device), builds the program and its
inputs from the seed and warms the shapes the mix uses in its constructor
(set-up), runs one unit of work in ``call(i)`` (ended by a synchronise;
-> the unit's work: audio seconds, model FLOPs, decode steps) and keeps
what the timed calls produced in ``kept``. Once the window has closed,
``release()`` frees the program's state; ``reference_outputs(precision)``
computes the same outputs in the same form with the plain reference
(``port_bench/reference``) in ``precision``, and ``check(precision)``
compares ``kept`` with them. The control (``port_bench.control``) puts the
reference's outputs in the control's precision into ``kept``.
"""
