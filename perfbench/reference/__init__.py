"""The plain references: one module a model family (``<family>.py``,
named by a configuration's ``"model"``), each with ``eps_widths``,
``init_params`` and ``loss``, and the pieces they share in
``common.py``.  Plain PyTorch only: nothing here imports the program
under test."""
