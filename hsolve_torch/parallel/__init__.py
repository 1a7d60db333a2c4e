"""Multi-device execution of the factorization and its solve over
``torch.distributed`` (port of ``hsolve/parallel``): :mod:`.dist` lays the
ranks out on a ("tree", "front") device mesh, :mod:`.exchange` moves the
child Schur panels between them, :mod:`.sharded` runs the schedule and the
solve sweeps on each rank's share, and :mod:`.dryrun` is the port of the
driver's ``entry`` / ``dryrun_multichip``."""
