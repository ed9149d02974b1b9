"""Host ms a batch in CUDA API calls that wait for the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and a plain ``cudaMemcpy``) under each
``atpu.decode.images`` range, traced slice; 0.0 when decode makes
none."""

from benchmark.metrics.decode_launches_per_batch import DECODE, calls_under

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    found = calls_under(run.events, DECODE)
    if found is None or not found[0]:
        return None
    rs, calls = found
    return sum(ev["dur"] for ev in calls if ev["name"] in SYNCS) / 1e3 \
        / len(rs)
