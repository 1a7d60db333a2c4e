// The loop state of one run of GMRES's restart cycles, in device memory:
// what hsolve/krylov.py `_gmres_cycles` carries through its two
// `lax.while_loop`s (the cycle loop, :314, and the step loop, :291).
// Read and written by the Arnoldi step (arnoldi_cgs2.cu, `hs_arnoldi_step`)
// and by the control kernels (gmres_control.cu); the Python side names the
// same slots (hsolve_torch/ops/gmres_control.py).
#pragma once

// int32 slots of `loop`
#define HS_LOOP_J 0        // the cycle's steps so far
#define HS_LOOP_IT 1       // the run's iterations (steps of finished cycles)
#define HS_LOOP_MAXITER 2  // the iteration budget
#define HS_LOOP_DONE 3     // 1 once the cycle takes no further step
#define HS_LOOP_CYC 4      // cycles run
#define HS_LOOP_NCYC 5     // the cycle budget
#define HS_LOOP_GO 6       // 1 while another cycle runs
#define HS_LOOP_LEN 8

// slots of `sc`, in the solution's real type
#define HS_SC_BNORM 0      // ||b||
#define HS_SC_TOL 1        // reltol ||b||
#define HS_SC_BETA 2       // the last true residual norm
#define HS_SC_RELTOL 3     // reltol (phase 2 of an escalated solve: reltol2)
#define HS_SC_LEN 4
