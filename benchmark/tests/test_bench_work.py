"""The operation and byte counts at small shapes, worked by hand."""

from benchmark import work


def test_knn_forward():
    # clouds (3 queries x 4 points) and (2 x 5), D=3, K=2:
    # pairs 12 + 10 = 22, ops 9 a pair; bytes: 12 B a point read for
    # 5 queries + 9 points, 12 B (dist + idx) a slot for 2 slots x 5 queries
    w = work.knn_forward([3, 2], [4, 5], 3, 2)
    assert w == {"ops": 22 * 9, "bytes": 12 * 14 + 12 * 2 * 5}


def test_chamfer_forward():
    # pairs 3*4 + 2*5 = 22 at 10 ops; points 5 + 9 = 14, each (3 coords +
    # 6 feature channels) float32 read and an int64 index written
    w = work.chamfer_forward([3, 2], [4, 5], 3, 6)
    assert w == {"ops": 22 * 10, "bytes": 14 * (9 * 4) + 14 * 8}


def test_knn_backward():
    # entries: 3 * min(2, 4) + 2 * min(2, 1) = 8, 12 ops and 12 B each;
    # 14 points read and their gradients written, 12 B each
    w = work.knn_backward([3, 2], [4, 1], 3, 2)
    assert w == {"ops": 8 * 12, "bytes": 8 * 12 + 2 * 12 * (5 + 5)}


def test_chamfer_backward():
    # entries 5 + 9 = 14 (each point's gradient and index read, 9 ops);
    # both sides' points read (12 B a point), x's 5 gradients written
    w = work.chamfer_backward([3, 2], [4, 5], 3)
    assert w == {"ops": 14 * 9, "bytes": 14 * 12 + 14 * 12 + 5 * 12}


def test_least_time_takes_the_binding_roof():
    assert work.least_s(67e12, 1.0, (67e12, 3.35e12)) == 1.0
    assert work.least_s(1.0, 3.35e12, (67e12, 3.35e12)) == 1.0
