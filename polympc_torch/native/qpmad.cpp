// Dense dual active-set QP solver (Goldfarb-Idnani 1983).
//
// TPU-native framework's analogue of the reference's QPMAD interface
// (src/solvers/qpmad_interface.hpp:18-126): a host-side C++ solver for
// small dense strictly convex QPs.  Active-set methods have data-dependent
// control flow (add/drop constraints until optimal) that cannot be expressed
// efficiently under XLA's static-shape compilation model, so this lives in
// native code on the host CPU; the batched TPU path is the (box)ADMM solver.
//
// Problem form (matches qp/types.py QPData):
//     min  1/2 x'Hx + h'x
//     s.t. al <= A x <= au      (m rows, duals y)
//          xl <=  x  <= xu      (n boxes, duals y_box)
// Sign convention of the returned duals: H x + h + A'y + y_box = 0
// (y > 0 at an active upper bound), the same as the ADMM solvers.
//
// Built with g++ -O3 -shared; called from Python via ctypes
// (polympc_tpu/qp/active_set.py).  No external dependencies.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr double kInf = 1e19;

// Solve L z = b in place (L lower-triangular, row-major n x n).
void forward_sub(const double* L, double* b, int n) {
    for (int i = 0; i < n; ++i) {
        double s = b[i];
        for (int j = 0; j < i; ++j) s -= L[i * n + j] * b[j];
        b[i] = s / L[i * n + i];
    }
}

// Solve L' z = b in place.
void backward_sub(const double* L, double* b, int n) {
    for (int i = n - 1; i >= 0; --i) {
        double s = b[i];
        for (int j = i + 1; j < n; ++j) s -= L[j * n + i] * b[j];
        b[i] = s / L[i * n + i];
    }
}

// In-place Cholesky H = L L' (row-major, lower). Returns false if not PD.
bool cholesky(std::vector<double>& M, int n) {
    for (int j = 0; j < n; ++j) {
        double d = M[j * n + j];
        for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
        if (d <= 0.0) return false;
        d = std::sqrt(d);
        M[j * n + j] = d;
        for (int i = j + 1; i < n; ++i) {
            double s = M[i * n + j];
            for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
            M[i * n + j] = s / d;
        }
        for (int k = j + 1; k < n; ++k) M[j * n + k] = 0.0;
    }
    return true;
}

// Solve the small SPD system (Nt Hinv N) r = rhs by fresh Cholesky (q <= n,
// q is small for MPC-sized host QPs; no incremental factor bookkeeping).
bool small_spd_solve(std::vector<double> S, double* rhs, int q) {
    if (!cholesky(S, q)) return false;
    forward_sub(S.data(), rhs, q);
    backward_sub(S.data(), rhs, q);
    return true;
}

struct Constraint {
    // normal is +/- a row of A or +/- e_j; b is the rhs of  n'x >= b
    int kind;      // 0: A-row lower, 1: A-row upper, 2: box lower, 3: box up
    int index;     // row / variable index
    double b;
    bool equality;
};

}  // namespace

extern "C" int qpmad_solve(
    int n, int m,
    const double* H, const double* h,
    const double* A, const double* al, const double* au,
    const double* xl, const double* xu,
    double* x_out, double* y_out, double* ybox_out,
    int max_iter, double tol, int* iters_out) {
    // status codes mirror polympc_tpu.utils.status
    constexpr int SOLVED = 1, MAX_ITER = 2, UNSOLVED = 3, INFEASIBLE = 4;

    // ---- enumerate one-sided constraints ----
    std::vector<Constraint> cons;
    cons.reserve(2 * (m + n));
    for (int i = 0; i < m; ++i) {
        bool has_l = al[i] > -kInf, has_u = au[i] < kInf;
        bool eq = has_l && has_u && (au[i] - al[i] <= tol);
        if (eq) { cons.push_back({0, i, al[i], true}); continue; }
        if (has_l) cons.push_back({0, i, al[i], false});
        if (has_u) cons.push_back({1, i, -au[i], false});
    }
    for (int j = 0; j < n; ++j) {
        bool has_l = xl[j] > -kInf, has_u = xu[j] < kInf;
        bool eq = has_l && has_u && (xu[j] - xl[j] <= tol);
        if (eq) { cons.push_back({2, j, xl[j], true}); continue; }
        if (has_l) cons.push_back({2, j, xl[j], false});
        if (has_u) cons.push_back({3, j, -xu[j], false});
    }
    const int nc = static_cast<int>(cons.size());

    // normal of constraint c dotted with a vector v
    auto dot_normal = [&](const Constraint& c, const double* v) -> double {
        switch (c.kind) {
            case 0: { double s = 0; for (int j = 0; j < n; ++j) s += A[c.index * n + j] * v[j]; return s; }
            case 1: { double s = 0; for (int j = 0; j < n; ++j) s += A[c.index * n + j] * v[j]; return -s; }
            case 2: return v[c.index];
            default: return -v[c.index];
        }
    };
    // write sgn * normal into dense vector out
    auto write_normal = [&](const Constraint& c, double* out) {
        std::memset(out, 0, sizeof(double) * n);
        switch (c.kind) {
            case 0: for (int j = 0; j < n; ++j) out[j] = A[c.index * n + j]; break;
            case 1: for (int j = 0; j < n; ++j) out[j] = -A[c.index * n + j]; break;
            case 2: out[c.index] = 1.0; break;
            default: out[c.index] = -1.0; break;
        }
    };

    // ---- factor H, unconstrained minimum ----
    std::vector<double> L(H, H + static_cast<size_t>(n) * n);
    if (!cholesky(L, n)) return UNSOLVED;  // not positive definite
    std::vector<double> x(n);
    for (int j = 0; j < n; ++j) x[j] = -h[j];
    forward_sub(L.data(), x.data(), n);
    backward_sub(L.data(), x.data(), n);

    // active set state
    std::vector<int> act;           // indices into cons
    std::vector<double> u;          // duals of active constraints (>= 0)
    std::vector<double> Ninv;       // Hinv * normals, column-packed (q x n)
    std::vector<double> Nmat;       // normals, column-packed (q x n)
    std::vector<double> d(n), z(n), nvec(n);
    std::vector<double> r;          // dual step direction

    int iter = 0;
    int pending = -1;  // constraint being added (survives drop sub-steps)
    double upend = 0.0;
    while (iter++ < max_iter) {
        int q = static_cast<int>(act.size());
        if (pending < 0) {
            // ---- pick the most violated inactive constraint ----
            double worst = tol;
            int p = -1;
            bool flip = false;  // for violated equalities: sign of the normal
            for (int c = 0; c < nc; ++c) {
                bool active = false;
                for (int a : act) if (a == c) { active = true; break; }
                if (active) continue;
                double v = cons[c].b - dot_normal(cons[c], x.data());
                if (cons[c].equality && -v > worst) { worst = -v; p = c; flip = true; }
                else if (v > worst) { worst = v; p = c; flip = false; }
            }
            if (p < 0) break;  // all satisfied: optimal
            pending = flip ? (p | (1 << 30)) : p;
            upend = 0.0;
        }

        const bool flipped = (pending & (1 << 30)) != 0;
        const Constraint& cp = cons[pending & ~(1 << 30)];
        write_normal(cp, nvec.data());
        if (flipped) for (int j = 0; j < n; ++j) nvec[j] = -nvec[j];
        const double bp = flipped ? -cp.b : cp.b;

        // ---- step directions ----
        // d = Hinv n+
        std::copy(nvec.begin(), nvec.end(), d.begin());
        forward_sub(L.data(), d.data(), n);
        backward_sub(L.data(), d.data(), n);
        r.assign(q, 0.0);
        std::copy(d.begin(), d.end(), z.begin());
        if (q > 0) {
            // r = (N' Hinv N)^{-1} N' d ;  z = d - (Hinv N) r
            std::vector<double> S(static_cast<size_t>(q) * q);
            for (int a = 0; a < q; ++a)
                for (int b2 = 0; b2 < q; ++b2) {
                    double s = 0;
                    for (int j = 0; j < n; ++j)
                        s += Nmat[a * n + j] * Ninv[b2 * n + j];
                    S[a * q + b2] = s;
                }
            for (int a = 0; a < q; ++a) {
                double s = 0;
                for (int j = 0; j < n; ++j) s += Nmat[a * n + j] * d[j];
                r[a] = s;
            }
            if (!small_spd_solve(S, r.data(), q)) return UNSOLVED;
            for (int j = 0; j < n; ++j) {
                double s = 0;
                for (int a = 0; a < q; ++a) s += Ninv[a * n + j] * r[a];
                z[j] = d[j] - s;
            }
        }

        // ---- step lengths ----
        double zn = 0.0;
        for (int j = 0; j < n; ++j) zn += z[j] * nvec[j];
        double viol = bp - dot_normal(cp, x.data()) * (flipped ? -1.0 : 1.0);
        double t2 = (zn > tol * tol) ? viol / zn : kInf;
        double t1 = kInf;
        int drop = -1;
        for (int a = 0; a < q; ++a) {
            if (cons[act[a]].equality) continue;  // never drop equalities
            if (r[a] > tol * tol) {
                double t = u[a] / r[a];
                if (t < t1) { t1 = t; drop = a; }
            }
        }
        if (t1 >= kInf && t2 >= kInf) return INFEASIBLE;
        double t = std::min(t1, t2);

        if (t2 < kInf) {
            for (int j = 0; j < n; ++j) x[j] += t * z[j];
        }
        // dual update includes the pending multiplier for both full and
        // partial (dual-only) steps (Goldfarb-Idnani step 2(c))
        upend += t;
        for (int a = 0; a < q; ++a) u[a] -= t * r[a];

        if (t2 <= t1) {
            // full step: add pending constraint to the active set
            act.push_back(pending & ~(1 << 30));
            u.push_back(upend);
            size_t off = Nmat.size();
            Nmat.resize(off + n);
            Ninv.resize(off + n);
            std::copy(nvec.begin(), nvec.end(), Nmat.begin() + off);
            std::copy(nvec.begin(), nvec.end(), Ninv.begin() + off);
            forward_sub(L.data(), Ninv.data() + off, n);
            backward_sub(L.data(), Ninv.data() + off, n);
            pending = -1;
        } else {
            // partial step: drop the blocking constraint, retry the add
            act.erase(act.begin() + drop);
            u.erase(u.begin() + drop);
            Nmat.erase(Nmat.begin() + static_cast<long>(drop) * n,
                       Nmat.begin() + static_cast<long>(drop + 1) * n);
            Ninv.erase(Ninv.begin() + static_cast<long>(drop) * n,
                       Ninv.begin() + static_cast<long>(drop + 1) * n);
        }
    }
    *iters_out = iter;
    if (iter > max_iter) return MAX_ITER;

    // ---- extract solution + duals in ADMM sign convention ----
    std::copy(x.begin(), x.end(), x_out);
    std::memset(y_out, 0, sizeof(double) * (m > 0 ? m : 1));
    std::memset(ybox_out, 0, sizeof(double) * n);
    for (size_t a = 0; a < act.size(); ++a) {
        const Constraint& c = cons[act[a]];
        // stationarity:  H x + h = sum_a u_a n_a  with u_a >= 0 and n_a the
        // normal as stored (including upper-side and equality-flip signs),
        // so the row's dual in  Hx + h + A'y + y_box = 0  is  y = -u_a * s
        // where  n_a = s * A_row  (or s * e_j for boxes).
        double sgn = 0.0;
        for (int j = 0; j < n; ++j) sgn += Nmat[a * n + j] *
            ((c.kind <= 1) ? A[c.index * n + j] : (j == c.index ? 1.0 : 0.0));
        double contrib = (sgn >= 0.0) ? -u[a] : u[a];
        if (c.kind <= 1) y_out[c.index] += contrib;
        else ybox_out[c.index] += contrib;
    }
    return SOLVED;
}
