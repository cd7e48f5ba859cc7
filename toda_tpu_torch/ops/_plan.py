"""What the Python launch plans of the hand-written kernels share: the
shared-memory limit of an H100 block, the 16-byte row strides of the staged
tiles (``gather_gemm.cuh`` ``Rows``), and the int array a plan is passed
to its kernel as."""

import ctypes

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def plan_ints(plan, fields):
    """``plan``'s values in the order of ``fields``, as the int32 array the
    kernels' C entries take."""
    return (ctypes.c_int32 * len(fields))(*(int(plan[f]) for f in fields))


def up(n, k):
    """n rounded up to a multiple of k."""
    return -(-n // k) * k


def pow2(n):
    return n > 0 and n & (n - 1) == 0


def row_stride(chunks, swizzle=True):
    """16-byte chunks a staged row of ``chunks`` chunks takes in shared
    memory (gather_gemm.cuh ``Rows``): a power of two is XOR-swizzled in
    place (when ``swizzle``) and an odd count is left as is; any other even
    count is padded by one chunk to an odd stride."""
    return chunks if (swizzle and pow2(chunks)) or chunks % 2 else chunks + 1
