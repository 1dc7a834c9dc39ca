"""The benchmark's shared pieces: cell loading and the run contract
(``common``), traffic generation (``traffic``), the device trace
(``trace``), the operation and byte counts and the card's peaks
(``flops``) and weights made from a seed (``weights``)."""
