"""CPU tests of the benchmark; the tests marked ``gpu`` run on the card."""
