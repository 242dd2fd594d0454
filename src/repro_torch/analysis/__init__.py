"""Cost analysis of the port's programs: the op-stream cost model the
fusion gate prices candidates with, and the roofline peak fit."""
