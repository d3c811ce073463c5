"""Device milliseconds a train step spends in every kernel launched inside
the port's qtrt.train.backward span (torch.autograd.grad of
diff.inverse.value_and_grad), the checkpoint's recompute included; the
autograd thread launches them while the calling thread waits in the span.
A sharded step's NCCL kernels (the gradients' all-reduce, which spins
until the slowest rank arrives) are left out: ``allreduce_ms_per_step``
and ``allreduce_wait_ms_per_step`` read them; a one-card step has none."""

from portbench.harness import spans, trace

LAYER = "train steps and autograd"
UNIT = "ms"
MOVES = "view_step_s"
WORKLOADS = ("cornell_c5.view_step",)


def read(run):
    return spans.within_ms_per_unit(run, spans.TRAIN_BACKWARD,
                                    lambda n: not trace.collective(n))
