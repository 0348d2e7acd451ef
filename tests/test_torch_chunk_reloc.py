"""The port's chunk program on the relocalisation streams == its
synchronous per-frame loop, and agrees with the JAX package's per-frame
loop, on the CPU:

* ``relocalize`` (relocalisations into maps whose arenas were moved off
  the device) in chunks of 4 and 8;
* ``rollback``: ``relocalize`` with two return-path frames blanked after
  the first return split (frames 16 and 17; the relocalisation comes at
  frame 12), so a Lost finish follows the relocalisation inside one
  chunk, as tests/test_chunked.py:108-135 builds it: in chunks of 16 and
  20, and at least one of them undoes the later finish on the device
  (``num_reloc_rollbacks``).

The rest of the chunk program's streams, the bounds and the unit cases
are in tests/test_torch_chunk.py.
"""
import pytest

from tests.test_torch_chunk import _chunked, _references, check_exact, check_jax, ids

CASES = [("relocalize", 4, 1), ("relocalize", 8, 1), ("rollback", 16, 1), ("rollback", 20, 1)]


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_equals_synchronous_loop(name, size, group):
    check_exact(name, size, group)


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_agrees_with_jax_per_frame(name, size, group):
    check_jax(name, size, group)


def test_relocalisation_rollback_is_taken():
    """At least one of the two chunkings of ``rollback`` places the Lost
    finish after the relocalisation in its chunk and undoes it on the
    device."""
    _, (sync_slam, _) = _references("rollback")
    runs = [_chunked("rollback", size, 1)[0] for size in (16, 20)]
    assert sync_slam.num_losses >= 1
    assert all(s.num_losses == sync_slam.num_losses for s in runs)
    assert sum(s.num_reloc_rollbacks for s in runs) >= 1
