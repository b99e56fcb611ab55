"""The code that drives a window, one file a traffic ``entry``: ``build(ctx)``
returns a cell with ``unit()`` (one call or slice of the program: (steps,
failed)), ``work()`` (the work a step needs, from the shapes),
``release()`` (frees the program's state) and ``check()`` (the compared
numbers, from the plain reference)."""
