"""``render.host_syncs`` in the cells whose end-to-end metric is the frames' tail
(``frame_ms_p95``) and not the rate: the same reading."""

import harness

read = harness.reader("metrics", "render.host_syncs").read
