"""Each cell cut to a size the CPU runs in seconds, for the tests."""

FILES = ["bamboo_flute", "cello", "clarinet", "flute", "guitar", "ocarina", "piano",
         "piccolo", "sax", "toy-accordian"]

OVERRIDES = {
    "ep_piano_100k": dict(T=400, inputs=2),
    "sep_mix3_16k": dict(T=96, inputs=2, ep_itts=3),
    "gaps_corpus10_53k": dict(pad_T=1200, lengths=[1000, 1200, 900, 1100, 800, 1150, 1050,
                                                    950, 1000, 850],
                              gap_centres={f: [300, 700] for f in FILES}),
}
