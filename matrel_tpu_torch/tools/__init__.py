"""Randomized correctness tools of the port — the counterparts of the JAX
package's ``tests/test_fuzz.py`` generator (:mod:`.fuzz`), ``tools/soak.py``
(:mod:`.soak`) and ``tools/chaos_drill.py`` (:mod:`.chaos_drill`). They
run on the card unless the caller asks for the CPU."""
