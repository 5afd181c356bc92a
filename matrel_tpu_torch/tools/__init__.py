"""Operator and correctness tools of the port — the counterparts of the JAX
package's ``tests/test_fuzz.py`` generator (:mod:`.fuzz`) and of its
``tools/`` files of the same names: the randomized soak (:mod:`.soak`),
the chaos and race drills, the plan-snapshot corpus and its verifier
(:mod:`.plan_snapshot`, :mod:`.plan_verify`), the weighted-mesh strategy
flip (:mod:`.topology_flip`), the flight-recorder and provenance drills,
the open-loop traffic harness (:mod:`.traffic`), the multi-process check
(:mod:`.multihost_check`) and the static lock-order analyzer
(:mod:`.lockcheck`). They run on the card unless the caller asks for the
CPU (``lockcheck`` reads source only)."""
