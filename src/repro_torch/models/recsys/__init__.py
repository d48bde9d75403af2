"""RecSys: DIN (Deep Interest Network) + embedding lookups."""
