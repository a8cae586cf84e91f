"""Shear observables, the particle statistics' interaction lines, the
hydrodynamic-radius and surface-tension calibrations and the other
specialised observables.

PyTorch port of ludwig_tpu/stats_extra.py: RheologyAccumulator,
interact_stats_lines and AhydroCalibration (the last two numpy only),
measure_sigma, rheology_profiles, shear_stress_mean, TurbulentStats and
SigmaCalibration (ref: stats_sigma.c, stats_rheology.c,
stats_turbulent.c).  The mean-stress xz section (ref:
stats_rheology.c:54-55 NSTAT2, :332-425
stats_rheology_stress_profile_accumulate, stats_rheology_stress_section),
switched on by the input keys freq_shear_measurement and
freq_shear_output.  The accumulator lives on the state's device in
float64 (the JAX package copies f to the host and sums in numpy float64);
a measurement reduces over y there, and only the (X, Z) section crosses
to the host, when a file is written.
"""

from __future__ import annotations

import numpy as np
import torch

TRIU = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def measure_sigma(fe, fields, axis: int = 0) -> float:
    """Surface tension from the excess free-energy density across a flat
    interface normal to `axis` (ref: stats_sigma.c method: integrate
    fed - fed_bulk through the interface; assumes two interfaces in a
    periodic box, returns the per-interface value)."""
    fed = fe.fed(fields)
    # bulk value = free energy of the pure phases (minimum of the bulk
    # potential): fed(phi*) with zero gradients
    phi_star = fe.phi_star
    fbulk = 0.5 * fe.a * phi_star ** 2 + 0.25 * fe.b * phi_star ** 4
    other = tuple(a for a in range(3) if a != axis)
    excess = torch.mean(fed - fbulk, dim=other)
    return 0.5 * float(torch.sum(excess))


def rheology_profiles(u: torch.Tensor, pth: torch.Tensor, axis: int = 0):
    """Mean velocity (3, L) and stress (3, 3, L) profiles along `axis`
    (ref: stats_rheology.c: mean over the perpendicular directions)."""
    uprof = torch.mean(u, dim=tuple(a + 1 for a in range(3) if a != axis))
    sprof = torch.mean(pth, dim=tuple(a + 2 for a in range(3) if a != axis))
    return uprof, sprof


def shear_stress_mean(f: torch.Tensor, model) -> float:
    """Volume-mean deviatoric S_xy from the distributions
    (ref: stats_rheology mean stress)."""
    cv = model.cv
    sxy = 0.0
    for p in range(model.nvel):
        cxy = float(cv[p][0] * cv[p][1])
        if cxy:
            sxy = sxy + cxy * f[p]
    return float(torch.mean(sxy))


class TurbulentStats:
    """Time-averaged velocity profile over the y direction
    (ref: src/stats_turbulent.c: ubar accumulate / zero / output).

    ubar holds the running sum of u over every (x, z) column, on the
    host in float64; output normalises by (time_counter * Ly) and writes
    the reference's ascii profile (one line per (x, z): ic kc ubar_x
    ubar_y ubar_z, 1-based coordinates)."""

    def __init__(self, size):
        self.size = tuple(size)
        self.ubar = np.zeros((size[0], size[2], 3))
        self.time_counter = 0

    def accumulate(self, u: torch.Tensor):
        ua = u.detach().cpu().numpy()       # (3, X, Y, Z)
        self.ubar += np.moveaxis(ua.sum(axis=2), 0, -1)
        self.time_counter += 1

    def zero(self):
        self.ubar[:] = 0.0
        self.time_counter = 0

    def output(self, path: str):
        norm = 1.0 / (max(self.time_counter, 1) * self.size[1])
        with open(path, "w") as fh:
            for ic in range(self.size[0]):
                for kc in range(self.size[2]):
                    v = self.ubar[ic, kc] * norm
                    fh.write(f"{ic + 1:4d} {kc + 1:4d} "
                             f"{v[0]:14.7e} {v[1]:14.7e} "
                             f"{v[2]:14.7e}\n")


class SigmaCalibration:
    """Surface-tension calibration via a droplet (ref: stats_sigma.c).

    Initialises phi as a drop of radius L/4 and width 2 xi0 at the box
    centre; measure() recovers the drop centre (mean of phi < 0 sites),
    radius (mean distance of sign-change crossings over the 26-site
    neighbourhood), interfacial width (best tanh fit over a binned
    radial profile, NFITMAX grid) and surface tension (excess free
    energy over the site minimum / drop area).  The measurement runs on
    the host in float64 numpy, as the JAX package's does, on phi and the
    free-energy density copied from the device.
    """

    NBIN, NFITMAX, XIINIT, XIPROFILE = 128, 2000, 2.0, 10.0

    def __init__(self, fe, size, mobility):
        self.fe = fe
        self.size = tuple(size)
        self.xi0 = float(np.sqrt(-2.0 * fe.kappa / fe.a))
        self.radius = 0.25 * size[0]
        self.phistar = float(np.sqrt(-fe.a / fe.b))
        self.diffusivity = -mobility / fe.a
        self.tdiff = (self.XIINIT * self.xi0) ** 2 / self.diffusivity

    def banner(self, out):
        out.write("\nSurface tension calibration via droplet initialised\n")
        out.write("---------------------------------------------------\n")
        out.write(f"Drop radius:     {self.radius:14.7e}\n")
        out.write(f"Cahn number:     {self.xi0 / self.radius:14.7e}\n")
        out.write(f"Diffusivity:     {self.diffusivity:14.7e}\n")
        out.write(f"Diffusion time:  {self.tdiff:14.7e}\n")

    def init_phi(self, dtype):
        """phi = phistar tanh((r - r0)/xi) on global site coords i+1
        (ref: field_phi_init_drop, is_centred = 0), a numpy array."""
        nx, ny, nz = self.size
        x = np.arange(1, nx + 1) - 0.5 * nx
        y = np.arange(1, ny + 1) - 0.5 * ny
        z = np.arange(1, nz + 1) - 0.5 * nz
        r = np.sqrt(x[:, None, None] ** 2 + y[None, :, None] ** 2
                    + z[None, None, :] ** 2)
        rxi = 1.0 / (self.XIINIT * self.xi0)
        return (self.phistar * np.tanh(rxi * (r - self.radius))).astype(dtype)

    def measure(self, phi, fields):
        """(radius, xi0 fit, sigma) of the drop in phi, whose free-energy
        fields are `fields` (binary.fe_fields)."""
        phin = torch.as_tensor(phi).detach().cpu().numpy().astype(np.float64)
        nx, ny, nz = self.size
        gx = np.arange(1, nx + 1, dtype=np.float64)
        gy = np.arange(1, ny + 1, dtype=np.float64)
        gz = np.arange(1, nz + 1, dtype=np.float64)
        neg = phin <= 0.0
        nneg = neg.sum()
        centre = np.array([
            (neg * gx[:, None, None]).sum() / nneg,
            (neg * gy[None, :, None]).sum() / nneg,
            (neg * gz[None, None, :]).sum() / nneg])
        # radius: interpolated sign-change crossings over 26 neighbours
        rsum = 0.0
        rcount = 0.0
        inside = phin < 0.0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if dx == 0 and dy == 0 and dz == 0:
                        continue
                    phi1 = np.roll(phin, (-dx, -dy, -dz), (0, 1, 2))
                    m = inside & (phi1 > 0.0)
                    if not m.any():
                        continue
                    frac = phin[m] / (phin[m] - phi1[m])
                    ii, jj, kk = np.nonzero(m)
                    rx = gx[ii] + frac * dx - centre[0]
                    ry = gy[jj] + frac * dy - centre[1]
                    rz = gz[kk] + frac * dz - centre[2]
                    rsum += np.sqrt(rx ** 2 + ry ** 2 + rz ** 2).sum()
                    rcount += m.sum()
        radius = rsum / rcount
        # xi: binned radial profile + best tanh fit
        rmin = radius - self.XIPROFILE * self.xi0
        rmax = radius + self.XIPROFILE * self.xi0
        dr = (rmax - rmin) / self.NBIN
        r0 = np.sqrt((gx[:, None, None] - centre[0]) ** 2
                     + (gy[None, :, None] - centre[1]) ** 2
                     + (gz[None, None, :] - centre[2]) ** 2)
        nb = np.floor((r0 - rmin) / dr).astype(np.int64)
        ok = (nb >= 0) & (nb < self.NBIN)
        phir = np.bincount(nb[ok], weights=phin[ok], minlength=self.NBIN)
        nphi = np.bincount(nb[ok], minlength=self.NBIN)
        has = nphi > 0
        phir[has] = phir[has] / nphi[has]
        rbin = rmin + (np.arange(self.NBIN) + 0.5) * dr
        xifits = 2.0 * (np.arange(self.NFITMAX) + 1) * self.xi0 \
            / self.NFITMAX
        prof = np.tanh((rbin[None, :] - radius) / xifits[:, None])
        cost = (((phir[None, :] - prof) ** 2) * has[None, :]).sum(axis=1)
        xi0fit = float(xifits[int(np.argmin(cost))])
        # sigma: excess free energy density over the minimum
        fed = self.fe.fed(fields).detach().cpu().numpy().astype(np.float64)
        excess = (fed - fed.min()).sum()
        if nz == 1:
            sigma = excess / (2.0 * np.pi * radius)
        else:
            sigma = excess / (4.0 * np.pi * radius * radius)
        return radius, xi0fit, sigma


def _hasimoto(a: float, length: float) -> float:
    """Finite-size correction fraction to Stokes drag
    (ref: stats_calibration.c:275-283)."""
    x = a / length
    return 1.0 - 2.837 * x + 4.19 * x ** 3 - 27.4 * x ** 6


class AhydroCalibration:
    """Hydrodynamic-radius calibration for a single driven colloid
    (ref: src/stats_calibration.c, switched on by `calibration on`).

    The particle is driven at target Reynolds number 0.05; after a
    momentum-diffusion spin-up, the mean hydrodynamic force and the
    particle velocity relative to the fluid are accumulated every
    nstokes/50 steps, and the hydrodynamic radius solved from the
    Hasimoto-corrected Stokes relation at the end.  The hydrodynamic
    force comes from the BBL implicit update via Newton's identity
    fhydro = m (v_new - v_old) - F_ext, which equals the reference's
    diagnostic f0 - zeta.v (ref: bbl.c:922-944) exactly for the
    wall-free calibration geometry."""

    REYNOLDS = 0.05
    PER_STOKES = 50        # measurements per Stokes time

    def __init__(self, ah: float, a0: float, eta: float, rho0: float,
                 colloid_rho0: float, size, gravity):
        length = float(size[2])
        self.a0 = float(ah)
        self.eta = float(eta)
        self.length = length
        self.utarget = eta * self.REYNOLDS / (self.a0 * rho0)
        fh = _hasimoto(self.a0, length)
        self.ftarget = 6.0 * np.pi * eta * self.a0 * self.utarget / fh
        self.nstokes = int(self.a0 / self.utarget)
        self.nfreq = max(1, self.nstokes // self.PER_STOKES)
        self.nstart = int(length * length / eta)
        # particle mass from the INPUT radius (ref: bbl.c:786)
        self.mass = (4.0 / 3.0) * np.pi * colloid_rho0 * float(a0) ** 3
        self.grav = np.asarray(gravity, np.float64)
        self.fbar = np.zeros(3)
        self.ubar = np.zeros(3)
        self.ndata = 0

    def banner(self, out):
        out.write("\n\nCalibration information:\n")
        out.write(f"Target Reynolds number:    {self.REYNOLDS:11.4e}\n")
        out.write(f"Target particle speed:     {self.utarget:11.4e}\n")
        out.write(f"Force applied:             {self.ftarget:11.4e}\n")
        out.write(f"Spin-up T_diffusion:       {self.nstart:11d}\n")
        out.write(f"Stokes time (timesteps):   {self.nstokes:11d}\n")
        out.write(f"Measurement frequency:     {self.nfreq:11d}\n\n\n")

    def wants(self, t: int) -> bool:
        return t >= self.nstart and t % self.nfreq == 0

    def accumulate(self, v_new, v_old, upart_minus_ufluid):
        """One measurement (ref: stats_ahydro_measure): v_new/v_old are
        the particle velocity after/before this step's BBL update,
        upart_minus_ufluid the particle velocity minus the fluid-site
        mean velocity."""
        self.ndata += 1
        self.fbar += self.mass * (np.asarray(v_new, np.float64)
                                  - np.asarray(v_old, np.float64)) \
            - self.grav
        self.ubar += np.asarray(upart_minus_ufluid, np.float64)

    def result(self):
        """(f0, u0, ah, fhasimoto) from the accumulated means, iterating
        the Hasimoto correction (ref: stats_ahydro_free)."""
        u = self.ubar / self.ndata
        f = self.fbar / self.ndata
        f0 = float(np.linalg.norm(f))
        u0 = float(np.linalg.norm(u))
        ah = self.a0
        for _ in range(10):
            fh = _hasimoto(ah, self.length)
            ah = 1.0 / (6.0 * np.pi * self.eta * u0 / f0
                        - (fh - 1.0) / ah)
        return f0, u0, ah, _hasimoto(ah, self.length)

    def report(self, out):
        t = 1.0 * self.ndata * self.nfreq / self.nstokes
        out.write("\n\nCalibration result\n")
        out.write(f"Number of measurements:    {self.ndata:11d}\n")
        out.write(f"Run time (Stokes times):   {t:11.4e}\n")
        if self.ndata < 1:
            return
        f0, u0, ah, fh = self.result()
        out.write("\n")
        out.write(f"Actual force:              {f0:11.4e}\n")
        out.write(f"Actual speed:              {u0:11.4e}\n")
        out.write(f"Hasimoto correction (a/L): {fh:11.4e}\n")
        out.write(f"Input radius:              {self.a0:11.4e}\n")
        out.write(f"Hydrodynamic radius:       {ah:11.4e}\n")
        out.write(f"Stokes equation rhs:       "
                  f"{6.0 * np.pi * self.eta * ah * u0:11.4e}\n")
        out.write(f"Stokes equation lhs:       {f0 * fh:11.4e}\n")


class RheologyAccumulator:
    """22 data items per (x, z) point, accumulated over y and time: 6
    components each of the measured second moment minus rho u u (the
    viscous stress up to a factor applied at output), the thermodynamic
    stress and rho u u; then the 3 velocity components; slot 21 is the
    reference's zero placeholder for the isotropic chemical stress."""

    def __init__(self, size, device="cuda"):
        self.size = tuple(size)
        self.stat = torch.zeros((self.size[0], self.size[2], 22),
                                dtype=torch.float64, device=device)
        self.count = 0

    def accumulate(self, f: torch.Tensor, model, pth=None):
        """Add one measurement of f (nvel, X, Y, Z) and, for a free energy
        with one, its thermodynamic stress pth (3, 3, X, Y, Z).  The sums
        over the velocities and over y run in order, one term after the
        other, as the JAX package's numpy sums take them."""
        f = f.to(torch.float64)
        cv = np.asarray(model.cv)

        def moment(weights):
            acc = None
            for p, w in enumerate(weights):
                if w:
                    term = f[p] if w == 1 else w * f[p]
                    acc = term if acc is None else acc + term
            return torch.zeros_like(f[0]) if acc is None else acc

        rho = moment(np.ones(len(cv)))
        mom = [moment(cv[:, a]) for a in range(3)]
        v = [m / rho for m in mom]
        cols = [moment(cv[:, a] * cv[:, b]) - v[a] * mom[b]
                for a, b in TRIU]
        if pth is None:
            cols += [torch.zeros_like(rho)] * 6
        else:
            pth = pth.to(torch.float64)
            cols += [pth[a, b] for a, b in TRIU]
        cols += [v[a] * mom[b] for a, b in TRIU]
        cols += v
        site = torch.stack(cols, dim=-1)               # (X, Y, Z, 21)
        acc = site[:, 0]
        for y in range(1, site.shape[1]):
            acc = acc + site[:, y]
        self.stat[:, :, :21] += acc
        self.count += 1

    def zero(self):
        self.stat.zero_()
        self.count = 0

    def write_section(self, path: str, eta: float):
        """str-%8.8d.dat: z runs fastest, 22 columns ' %15.8e' (ref:
        stats_rheology_stress_section; the viscous factor is -rcs2 eta /
        tau = -3 eta 2 / (1 + 6 eta))."""
        viscous = -3.0 * eta * 2.0 / (1.0 + 6.0 * eta)
        ravg = (1.0 / (self.size[1] * self.count)) if self.count else 0.0
        dat = self.stat.cpu().numpy() * ravg
        dat[:, :, :6] *= viscous
        with open(path, "w") as fh:
            for i in range(self.size[0]):
                for k in range(self.size[2]):
                    fh.write("".join(f" {x:15.8e}" for x in dat[i, k]))
                    fh.write("\n")


def interact_stats_lines(rt, cp, R, box):
    """The "Particle statistics:" interaction report lines printed each
    statistics step (ref: interaction.c:226-340 interact_stats; the
    per-potential accumulators are filled during the force sweep,
    pair_ss_cut.c:195-250 etc.).

    R: (N, 3) positions at report time; box: lattice extents.  Pair
    minima are taken over ALL distinct pairs (the reference's cell-list
    sweep restricts to neighbouring cells - identical whenever the
    closest pair lies within the interaction neighbourhood, which the
    cell-width checks enforce for interacting runs).  Returns the list
    of formatted lines, in the reference's order.
    """
    import numpy as _np
    N = cp.n
    lines = []
    R = _np.asarray(R[:N], _np.float64)
    L = _np.asarray(box, _np.float64)
    ah = _np.asarray(cp.ah if cp.ah else cp.a0, _np.float64)[:N]
    lmax = float(L.max())

    d = R[:, None, :] - R[None, :, :]
    d -= L * _np.round(d / L)
    r = _np.sqrt((d * d).sum(-1))
    iu = _np.triu_indices(N, 1)
    rp = r[iu] if N > 1 else _np.array([])
    hp = (r - ah[:, None] - ah[None, :])[iu] if N > 1 else _np.array([])

    # The reference's pair sweep only visits pairs in ADJACENT cells
    # of its cell list (pair_ss_cut.c:199-226); a genuinely closer
    # pair two cells away is invisible to its hmin/energy
    # accumulators, so the reported statistics are cell-list-relative.
    # Reproduce the cell geometry (colloids_rt.c:600-670) and mask.
    if N > 1:
        a0 = _np.asarray(cp.a0, _np.float64)[:N]
        hcmax, rcmax = 0.0, 0.0
        if rt.int("soft_sphere_on", 0):
            hcmax = max(hcmax, rt.double("soft_sphere_cutoff", 0.0))
        if rt.switch("pair_ss_cut_ij", False):
            ntyp = rt.int("pair_ss_cut_ij_ntypes", 1)
            nsymm = ntyp * (ntyp + 1) // 2
            hcv = rt.double_vector("pair_ss_cut_ij_hc", [0.0])
            hcmax = max([hcmax] + list(hcv[:nsymm]))
        if rt.int("lubrication_on", 0):
            hcmax = max(hcmax,
                        rt.double("lubrication_normal_cutoff", 0.0),
                        rt.double("lubrication_tangential_cutoff", 0.0))
        if rt.int("lennard_jones_on", 0):
            rcmax = max(rcmax, rt.double("lj_cutoff", 0.0))
        if rt.int("yukawa_on", 0):
            rcmax = max(rcmax, rt.double("yukawa_cutoff", 0.0))
        if rt.int("bond_fene_on", 0):
            rcmax = max(rcmax, rt.double("bond_fene_r0", 0.0))
        fe_nm = rt.string("free_energy", "none")
        nhalo = {"none": 1, "symmetric_noise": 3, "symmetric_lb": 1,
                 "brazovskii": 3}.get(fe_nm, 2)
        if fe_nm == "fe_electro":
            meth = rt.string("_force_line",
                             rt.string("fe_force_method", "")) or ""
            nhalo = 1 if meth.endswith("phi_gradmu_correction") else 2
        a0max = max(1.0, float(a0.max()))
        rmax = max(2.0 * float(ah.max()) + hcmax, rcmax, 1.5,
                   a0max + nhalo - 0.5)
        ncell = [int(_np.floor(L[a] / rmax)) for a in range(3)]
        if not any(b > 2 for b in ncell):
            ncell = [2, 2, 2]
        lcell = _np.array([L[a] / ncell[a] for a in range(3)])
        # our R is 0-based; reference r = R + 1 with lmin = 0.5
        ic = _np.floor((R + 0.5) / lcell[None, :]).astype(int)
        ic = ic % _np.array(ncell)[None, :]
        dc = _np.abs(ic[:, None, :] - ic[None, :, :])
        dc = _np.minimum(dc, _np.array(ncell)[None, None, :] - dc)
        neigh = (dc <= 1).all(-1)[iu]
    else:
        neigh = _np.array([], bool)
    rp = _np.where(neigh, rp, _np.inf)
    hp = _np.where(neigh, hp, _np.inf)

    def _pmin(arr):
        m = float(arr.min()) if arr.size else _np.inf
        return m if _np.isfinite(m) else lmax

    walls = [bool(w) for w in rt.int_vector("boundary_walls", (0, 0, 0))]
    if rt.switch("wall_ss_cut_on", False) and any(walls):
        eps = rt.double("wall_ss_cut_epsilon", 0.0)
        sig = rt.double("wall_ss_cut_sigma", 0.0)
        nu = rt.double("wall_ss_cut_nu", 1.0)
        hc = rt.double("wall_ss_cut_hc", 0.0)
        vcut = eps * (sig / hc) ** nu
        dvcut = -eps * nu / sig * (sig / hc) ** (nu + 1)
        hmin, v = lmax, 0.0
        for a in range(3):
            if not walls[a]:
                continue
            # our R is 0-based (ref r = R + 1, lmin = 0.5):
            # h = (r - lmin) - ah = R + 0.5 - ah on the lower face
            # (ref: wall_ss_cut.c:184-208)
            for hall in (R[:, a] + 0.5 - ah,
                         (L[a] - 0.5) - R[:, a] - ah):
                hmin = min(hmin, float(hall.min()))
                sel = hall < hc
                if sel.any():
                    h = hall[sel]
                    v += float((eps * (sig / h) ** nu - vcut
                                - (h - hc) * dvcut).sum())
        lines.append(f"Wall potential minimum h is: {hmin:14.7e}\n")
        lines.append(f"Wall potential energy is:    {v:14.7e}\n")

    if N > 1 and rt.int("lubrication_on", 0):
        lines.append(f"Lubrication minimum h is:    "
                     f"{_pmin(hp):14.7e}\n")

    if N > 1 and rt.int("soft_sphere_on", 0):
        eps = rt.double("soft_sphere_epsilon", 0.0)
        sig = rt.double("soft_sphere_sigma", 0.0)
        nu = rt.double("soft_sphere_nu", 1.0)
        hc = rt.double("soft_sphere_cutoff", 0.0)
        vcut = eps * (sig / hc) ** nu
        dvcut = -eps * nu / sig * (sig / hc) ** (nu + 1)
        sel = hp < hc
        h = hp[sel]
        v = float((eps * (sig / h) ** nu - vcut
                   - (h - hc) * dvcut).sum()) if sel.any() else 0.0
        lines.append(f"Pair potential minimum h is: "
                     f"{_pmin(hp):14.7e}\n")
        lines.append(f"Pair potential energy is:    {v:14.7e}\n")

    if N > 1 and rt.switch("pair_ss_cut_ij", False):
        # per-type-pair soft sphere (ref: pair_ss_cut_ij.c:285-330:
        # same hmin sweep, per (it1, it2) parameters)
        ntyp = rt.int("pair_ss_cut_ij_ntypes", 1)
        nsy = ntyp * (ntyp + 1) // 2
        epsv = rt.double_vector("pair_ss_cut_ij_epsilon", [0.0])
        sigv = rt.double_vector("pair_ss_cut_ij_sigma", [0.0])
        nuv = rt.double_vector("pair_ss_cut_ij_nu", [0.0])
        hcv = rt.double_vector("pair_ss_cut_ij_hc", [0.0])
        em = _np.zeros((ntyp, ntyp))
        sm, nm, hm = em.copy(), em.copy(), em.copy()
        k = 0
        for i in range(ntyp):
            for j in range(i, ntyp):
                em[i, j] = em[j, i] = epsv[k]
                sm[i, j] = sm[j, i] = sigv[k]
                nm[i, j] = nm[j, i] = nuv[k]
                hm[i, j] = hm[j, i] = hcv[k]
                k += 1
        it = _np.array([rt.int(f"colloid_{w}_interact_type", 0)
                        for w in ("one", "two", "three")[:min(N, 3)]]
                       + [0] * max(0, N - 3), int)
        e_p = em[_np.ix_(it, it)][iu]
        s_p = sm[_np.ix_(it, it)][iu]
        n_p = nm[_np.ix_(it, it)][iu]
        h_p = hm[_np.ix_(it, it)][iu]
        sel = hp < h_p
        v = 0.0
        if sel.any():
            h, e_, s_, n_, hcp = (a[sel] for a in
                                  (hp, e_p, s_p, n_p, h_p))
            # zero-eps pairs contribute nothing; guard the division
            s_ = _np.where(s_ == 0.0, 1.0, s_)
            hcp = _np.where(hcp == 0.0, 1.0, hcp)
            vcut = e_ * (s_ / hcp) ** n_
            dvcut = -e_ * n_ / s_ * (s_ / hcp) ** (n_ + 1.0)
            v = float((e_ * (s_ / h) ** n_ - vcut
                       - (h - hcp) * dvcut).sum())
        lines.append(f"Pair potential minimum h is: "
                     f"{_pmin(hp):14.7e}\n")
        lines.append(f"Pair potential energy is:    {v:14.7e}\n")

    if N > 1 and rt.int("lennard_jones_on", 0):
        eps = rt.double("lj_epsilon", 0.0)
        sig = rt.double("lj_sigma", 0.0)
        rc = rt.double("lj_cutoff", 1.0)
        rs_c = (sig / rc) ** 6
        vcut = 4.0 * eps * (rs_c * rs_c - rs_c)
        dvcut = -24.0 / rc * eps * (2.0 * rs_c * rs_c - rs_c)
        sel = rp < rc
        rr = rp[sel]
        rs = (sig / rr) ** 6
        v = float((4.0 * eps * (rs * rs - rs) - vcut
                   - (rr - rc) * dvcut).sum()) if sel.any() else 0.0
        lines.append(f"Pair potential minimum h is: "
                     f"{_pmin(hp):14.7e}\n")
        lines.append(f"Pair potential energy is:    {v:14.7e}\n")

    if N > 1 and rt.int("yukawa_on", 0):
        eps = rt.double("yukawa_epsilon", 0.0)
        kappa = rt.double("yukawa_kappa", 1.0)
        rc = rt.double("yukawa_cutoff", 1.0)
        vcut = eps * _np.exp(-kappa * rc) / rc
        dvcut = -eps * _np.exp(-kappa * rc) * (kappa / rc + 1.0 / rc**2)
        sel = rp < rc
        rr = rp[sel]
        v = float((eps * _np.exp(-kappa * rr) / rr - vcut
                   - (rr - rc) * dvcut).sum()) if sel.any() else 0.0
        lines.append(f"Pair potential minimum h is: "
                     f"{_pmin(hp):14.7e}\n")
        lines.append(f"Pair potential energy is:    {v:14.7e}\n")

    bonds = _np.array(getattr(cp, "bonds", ()), _np.int32).reshape(-1, 2) \
        if getattr(cp, "bonds", ()) else _np.zeros((0, 2), _np.int32)
    if rt.int("bond_fene_on", 0) and bonds.size:
        k = rt.double("bond_fene_k", 0.0)
        r0 = rt.double("bond_fene_r0", 1.0)
        i, j = bonds[:, 0], bonds[:, 1]
        rb = r[i, j]
        v = float((-0.5 * k * r0 * r0
                   * _np.log(1.0 - (rb / r0) ** 2)).sum())
        lines.append(f"Bond potential minimum r is: "
                     f"{float(rb.min()):14.7e}\n")
        lines.append(f"Bond potential maximum r is: "
                     f"{float(rb.max()):14.7e}\n")
        lines.append(f"Bond potential energy is:    {v:14.7e}\n")

    angles = _np.array(getattr(cp, "angles", ()),
                       _np.int32).reshape(-1, 3) \
        if getattr(cp, "angles", ()) else _np.zeros((0, 3), _np.int32)
    if rt.int("angle_cosine_on", 0) and angles.size:
        k = rt.double("angle_cosine_k", 0.0)
        # centre particle i with bonded neighbours (j, l):
        # v = kappa (1 + cos theta), theta the j-i-l angle
        # (ref: angle_cosine.c:140-210); stored as (j, i, l)
        j, i, l = angles[:, 0], angles[:, 1], angles[:, 2]
        d0 = d[i, j]
        d1 = d[i, l]
        c = ((d0 * d1).sum(-1)
             / _np.sqrt((d0 * d0).sum(-1) * (d1 * d1).sum(-1)))
        # v accumulates kappa*cos(theta) (the constant term is dropped:
        # ref angle_cosine.c:213 vlocal += kappa*cosine), and the
        # min/max lines are RADIANS of the min/max COSINE - so the
        # "minimum" line is acos(cosine_min), numerically the largest
        # angle (ref: angle_cosine.c:236-237)
        v = float((k * c).sum())
        amin = float(_np.arccos(c.min()))
        amax = float(_np.arccos(c.max()))
        lines.append(f"Angle minimum angle is:      {amin:14.7e}\n")
        lines.append(f"Angle maximum angle is:      {amax:14.7e}\n")
        lines.append(f"Angle potential energy is:   {v:14.7e}\n")
    return lines
