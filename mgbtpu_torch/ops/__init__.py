"""Host block operators, the nested-dissection direct solver, the dense
shifted-Cholesky inverse and the 128-blocked sparse tiles of the large-level
preconditioners."""
from .blockdiag import BlockDiagHost, block_column_sparse, extract_block_diag

__all__ = ["BlockDiagHost", "extract_block_diag", "block_column_sparse"]
