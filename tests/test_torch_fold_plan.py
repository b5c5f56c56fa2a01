"""The launch plan of the int8 / int4 folds (csrc/int4.cu), on the CPU.

``fold_plan`` gives the kernel's clusters of 64-query blocks, its ring
slots and its shared memory; the kernel checks the same sum
(``anr_fold_smem_bytes``, held against the plan on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``). Here: every
query block and every tile is covered once, a cluster holds at most four
blocks, one CTA per SM fills the card, and the shared memory stays within
an H100 CTA's 227 KB.
"""

import pytest
import torch

from a_nice_rag_tpu_torch.ops.kernels import int4
from a_nice_rag_tpu_torch.probes import int4 as int4_probe

N = 10_485_760
SMS = 132


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [8, 1024, 2048])
@pytest.mark.parametrize("b", [1, 8, 64, 256])
def test_fold_plan_grid_cluster_and_shared_memory(b, d, packed):
    plan = int4.fold_plan(N, b, d, packed, SMS)
    blocks = -(-b // int4.BLOCK_Q)
    assert plan.cluster == blocks and plan.groups == 1  # B <= 256
    assert 1 <= plan.cluster <= int4.MAX_CLUSTER
    assert plan.grid == (plan.per_group * plan.cluster, 1)
    # One CTA per SM: as many clusters as fit on the card at once.
    assert plan.per_group == SMS // plan.cluster
    assert plan.grid[0] <= SMS
    assert plan.tiles == -(-N // int4.TILE_DOCS)
    assert plan.smem_bytes <= int4.SMEM_LIMIT < 227 * 1024 + 1
    assert plan.smem_bytes == int4.fold_smem_bytes(d, packed, plan.stages,
                                                   plan.resident)
    erow = d // 2 if packed else d
    # TMA where the rows are whole 16-byte segments and one box wide.
    assert plan.tma == (erow % 16 == 0 and erow >= int4.CHUNK_BYTES
                        and plan.resident)
    # As many 32 KB slots as fit beside the query block (and the packed
    # rows' 64 KB of unpacked tiles), at most six; packed D = 2048 streams
    # its query chunks through the ring.
    assert (plan.resident, plan.stages) == {
        (8, False): (True, 6), (1024, False): (True, 5),
        (2048, False): (True, 3), (8, True): (True, 4),
        (1024, True): (True, 3), (2048, True): (False, 3)}[d, packed]


def test_fold_plan_shared_memory_sums():
    # Slack, 5 slots of 256 x 128 bytes, the 64 x 1024 query block, 10
    # barriers: stage C's int8 fold at B = 256.
    plan = int4.fold_plan(N, 256, 1024, False, SMS)
    assert plan.smem_bytes == 1024 + 5 * 32768 + 65536 + 80
    # Packed rows: both query halves (the same 64 KB at D = 1024), the
    # unpacked lo and hi tiles of 256 docs, 3 slots.
    assert int4.fold_plan(N, 256, 1024, True, SMS).smem_bytes \
        == 1024 + 3 * 32768 + 65536 + 65536 + 48


@pytest.mark.parametrize("b,groups,cluster", [
    (257, 2, 3), (300, 2, 3), (512, 2, 4), (513, 3, 3), (1000, 4, 4),
])
def test_fold_plan_groups_past_one_cluster(b, groups, cluster):
    plan = int4.fold_plan(N, b, 1024, False, SMS)
    assert (plan.groups, plan.cluster) == (groups, cluster)
    assert plan.groups * plan.cluster * int4.BLOCK_Q >= b
    assert plan.groups * (plan.cluster - 1) * int4.BLOCK_Q < b
    assert plan.per_group * plan.cluster * plan.groups <= SMS


@pytest.mark.parametrize("d,packed", [(4096, False), (3000, False),
                                      (8192, True)])
def test_fold_plan_streams_a_query_block_that_does_not_fit(d, packed):
    plan = int4.fold_plan(N, 256, d, packed, SMS)
    assert not plan.resident and not plan.tma
    assert plan.stages >= 2 and plan.smem_bytes <= int4.SMEM_LIMIT


def test_fold_plan_small_and_unaligned_rows():
    # Fewer tiles than clusters: one cluster per tile.
    assert int4.fold_plan(100, 256, 1024, False, SMS).per_group == 1
    # A base that is not 16-byte aligned, rows below one box or one
    # chunk: the producer's element loads.
    assert not int4.fold_plan(N, 256, 1024, False, SMS, aligned=False).tma
    assert not int4.fold_plan(63, 8, 1024, False, SMS).tma
    assert not int4.fold_plan(N, 8, 1000, False, SMS).tma
    assert not int4.fold_plan(N, 8, 40, True, SMS).tma
    # The card's count of resident clusters bounds the grid.
    assert int4.fold_plan(N, 256, 1024, False, SMS,
                          active_clusters=30).per_group == 30


@pytest.mark.parametrize("d", int4_probe.EDGE_D)
def test_fold_edge_data_puts_every_product_below_zero(d):
    # The all-negative case: every row's best product is negative, so a
    # zero-filled padding row would win the max if the kernel folded it.
    q8, e8, packed = int4_probe.edge_data(torch.device("cpu"), 100, d, 17,
                                          True, d)
    assert int(int4.int8_fold_max_torch(q8, e8).max()) < 0
    assert int(int4.int4_fold_max_torch(q8, packed).max()) < 0
    q8, e8, packed = int4_probe.edge_data(torch.device("cpu"), 100, d, 17,
                                          False, d)
    assert int(q8.min()) == -128 and int(q8.max()) == 127
    e4 = int4.unpack_int4(packed)
    assert int(e4.min()) == -8 and int(e4.max()) == 7


def test_fold_edges_on_cpu_take_the_plain_versions():
    out = int4_probe.check_edges(torch.device("cpu"), ns=(100, 301),
                                 ds=(8, 40), bs=(1, 65))
    assert out["exact"] and out["cases"] == 2 * 2 * 3
