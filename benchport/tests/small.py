"""The small sizes the CPU tests run each cell at: the configuration's
and the traffic's keys that change, and a short window."""

SMALL = {
    "gk-smc-1m": ({"smc": {"nparticles": 256, "epstol": 0.35}, "ndraws": 48},
                  {"judged_walkers": 512}),
    "normal-ais-131k": ({"ais": {"nwalkers": 256}, "ndraws": 48},
                        {"block_sweeps": 3, "judged_sweeps": 2,
                         "judged_walkers": 64}),
}
SECONDS = 0.2
# a traced run on the CPU profiles the plain versions' many small ops:
# fewer walkers and draws keep it short
TRACED = {"gk-smc-1m": ({"smc": {"nparticles": 128, "epstol": 0.35},
                         "ndraws": 16}, {"judged_walkers": 256})}
