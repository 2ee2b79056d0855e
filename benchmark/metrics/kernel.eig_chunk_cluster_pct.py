"""How often ``eig_chunk`` runs its cluster layout over the traced span:
the share of the span's device events of ``eig_chunk_kernel`` whose name
holds ``eig_chunk_kernel_cluster`` (a thread-block cluster of C blocks for
each live slot, the layout of calls with few live slots), in percent of
the events. Layer: the chunk kernel (``ops/admm_eig.py`` ->
``csrc/eig_chunk.cu``); the narrow calls it takes off the one-slot blocks
move the throughput. None where the span holds no ``eig_chunk`` event."""

UNIT = "%"
KERNEL, CLUSTER = "eig_chunk_kernel", "eig_chunk_kernel_cluster"


def read(run):
    t = run.trace
    if t is None:
        return None
    names = [e.get("name", "") for e in t["events"]
             if e.get("ph") == "X" and e.get("cat") == "kernel"
             and KERNEL in e.get("name", "")]
    if not names:
        return None
    return 100.0 * sum(CLUSTER in n for n in names) / len(names)
