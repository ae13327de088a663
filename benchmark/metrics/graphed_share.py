"""Train step, on the host (``TexturePipeline.train_step``): the share of
the profiled recorded stretch's steps that replayed the step's CUDA graphs
(``models/step_graph.py``), the program's ``step_graph_replays`` counter
over the stretch's steps, in percent (``progtrace.py``). None on a program
without the counter."""

from benchmark import progtrace


def read(record):
    join = progtrace.read(record)
    if join is None or join.steps <= 0:
        return None
    replays = join.counters.get("step_graph_replays")
    return None if replays is None else 100.0 * replays / join.steps
