"""The timeline's reading: busy time as the union of device operations,
idle gaps put down to the innermost host event at their middle."""
from bench import trace


class Ev:
    def __init__(self, name, kind, start, end, thread=1):
        self._n, self._k, self._s, self._e, self._t = (name, kind, start,
                                                       end, thread)

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t


def test_summarize_busy_gaps_and_names():
    events = [
        Ev(trace.CALL, "user_annotation", 0, 100),
        Ev(trace.CALL, "user_annotation", 100, 200),
        Ev(trace.CALL, "gpu_user_annotation", 0, 200),    # not an op
        Ev("k1", "kernel", 10, 30), Ev("k2", "kernel", 20, 50),
        Ev("k1", "kernel", 120, 150),
        Ev("Memcpy DtoH", "gpu_memcpy", 190, 195),
        Ev("aten::sort", "cpu_op", 40, 95),
        Ev("cudaLaunchKernel", "cuda_runtime", 60, 80),
        Ev("cudaStreamSynchronize", "cuda_runtime", 150, 199),
        Ev("aten::sort", "cpu_op", 40, 95, thread=2),    # another thread
    ]
    s = trace.summarize(events, calls=2)
    assert s["calls"] == 2 and s["kernels"] == 3
    assert abs(s["window_s"] - 200e-9) < 1e-15
    assert abs(s["busy_s"] - 75e-9) < 1e-15         # 10-50, 120-150, 190-195
    assert abs(s["kernel_s"] - 80e-9) < 1e-15
    ops = dict(s["device_ops"])
    assert abs(ops["k1"] - 50e-9) < 1e-15 and "gpu_user_annotation" not in ops
    idle = dict(s["idle_gaps"])
    # gaps 0-10 (mid 5: the call), 50-120 (mid 85: the sort, as the
    # launch inside it ended at 80), 150-190 and 195-200 (the sync)
    assert "cudaLaunchKernel" not in idle
    assert abs(idle["aten::sort"] - 70e-9) < 1e-15
    assert abs(idle["cudaStreamSynchronize"] - 45e-9) < 1e-15
    assert abs(idle[trace.CALL] - 10e-9) < 1e-15
