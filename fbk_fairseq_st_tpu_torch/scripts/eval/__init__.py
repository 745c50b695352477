"""The FBK papers' evaluation scripts (MuST-SHE, NE/terminology accuracy)."""
