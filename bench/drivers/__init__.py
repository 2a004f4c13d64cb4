"""The general drivers, one module each, found by the ``driver`` a
traffic mix names: ``bench/drivers/<driver>.py`` defines ``Driver``.

A driver has ``kind`` (which limits of the configuration hold),
``setup(run)``, ``window(run, state)``, ``answers`` (what the window
produced), ``work`` (the traced window's operations and bytes),
``stop`` (the program's release), ``check`` (the numbers compared with
the reference), ``end_to_end``, ``attempted`` and ``report``. Set-up
builds the program and the inputs from the seed, the window measures.
Everything the program computes goes through its public entry points;
a driver adds only timing and recording around them.
"""
