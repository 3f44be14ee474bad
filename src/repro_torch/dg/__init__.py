"""The hp DGSEM elastic-acoustic wave solver in PyTorch: ``basis``, ``mesh``,
``operators``, ``rk`` and ``solver`` (``DGSolver``, ``make_two_tree_solver``,
``gaussian_pulse``).

Nothing is imported here: ``kernels.ref`` imports ``dg.operators``, and
``dg.solver`` imports the kernels, so importing the solver from this
package's ``__init__`` would close an import cycle."""
